"""The benchmark's one command:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It runs one cell on the card: set-up (data,
seeded weights, the program built, every shape of the cell warmed up),
the measured window of ``--seconds``, then the check of what the window
produced against the plain reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; then ``checks``, each compared
number with its limit, which also close standard error. Without a card, or
with fewer cards than the cell asks for, it exits 3 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional, Sequence  # noqa: E402

from benchmark import harness  # noqa: E402


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_metrics(bench: Dict, cell: str, section: str) -> List[Dict]:
    """The ``section`` metrics that ``cell`` reports: those that list it, and
    those without a list whose ``moves`` metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def main(argv: Optional[Sequence[str]] = None, device=None, root: str = harness.CHECKOUT,
         t0: float = T0) -> Dict:
    """Run one cell and print its result line; returns it. ``device`` is
    for the tests alone: the command never passes it, and without it the
    run needs the cell's cards."""
    args = parse(argv)
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        raise SystemExit(f"no workload {args.workload!r} in BENCHMARK.json")
    workload = harness.load_json(harness.find(root, "workloads", args.workload, ".json"))
    config = harness.load_json(harness.find(root, "configs", entry["config"], ".json"))
    os.environ.update(harness.cache_environment(root))

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA card(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            raise SystemExit(3)
        device = "cuda"
    ctx = harness.Context(name=args.workload, workload=workload, config=config, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=torch.device(device), chips=entry["chips"], t0=t0, root=root)
    driver = harness.load_module(harness.find(root, "drivers", workload["driver"], ".py"))
    if ctx.device.type == "cuda":
        harness.build_kernels()
        ctx.phase("kernels built")
    out = driver.run(ctx)

    metrics = {}
    if ctx.trace:
        for m in cell_metrics(bench, args.workload, "per_layer"):
            reader = harness.load_module(harness.find(root, "metrics", m["name"], ".py"))
            value = reader.read(ctx, out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    limits = workload["limits"]
    numbers = out["numbers"]
    from benchmark.compare import check_lines, verdict

    correct = verdict(numbers, limits) and out["failed"] == 0
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                    else "cpu"),
           "count": ctx.chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    reading = out.get("trace")
    if ctx.trace and reading is not None:
        dev["busy_s"], dev["window_s"] = reading.busy_s, reading.window_s
        line["breakdown"] = {"device_ops": reading.device_ops(), "idle_gaps": reading.idle_gaps()}
    line["checks"] = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    bad = harness.forbidden_modules()
    if bad:
        print(f"sys.modules holds {bad} after the window: no run may load JAX or the JAX "
              "package", file=sys.stderr)
        raise SystemExit(4)
    print("set-up phases (s from start): " + ", ".join(f"{n} {t:.3f}" for n, t in ctx.phases),
          file=sys.stderr)
    for text in check_lines(numbers, limits):
        print(text, file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    return line


if __name__ == "__main__":
    main()
