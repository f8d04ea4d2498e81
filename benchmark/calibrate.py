"""The readings that the limits of ``correct`` are set from; the benchmark's
own runs never run this.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--seconds 1]
        [--program-fault half_batch]

For each seed, in one process: a run of the cell (set-up, a short window,
the check), whose numbers are the program's lower readings; then, on the
same inputs, the control (``reference/lowp.py``: the reference one
precision below the configuration's, in the program's place) against the
float32 reference; for a training cell also the fault of half the batch
left out (the reference in the program's place, trained on the first half
of each batch's rows). With ``--program-fault half_batch`` the fault is
planted in the program instead (its loss the mean over the first half of
each batch's rows), and the run's own numbers are its readings. One JSON
line per seed goes to standard output: the program's numbers and
end-to-end metrics, the control's numbers, and each fault's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from benchmark import compare, harness
from benchmark.reference.lowp import rounding
from benchmark.reference.steps import nearest_index, plain_float32, serve_logits, train_steps


def half_batch_loss(make_loss_fn):
    """The program's loss factory with half of each batch left out: the
    loss is the mean over the first half of the rows (a planted fault)."""
    def make(*args, **kwargs):
        inner = make_loss_fn(*args, **kwargs)
        return lambda logits, targets: inner(logits[: len(logits) // 2],
                                             targets[: len(targets) // 2])
    return make


def train_readings(ctx, inputs, faults: bool = True) -> dict:
    t = harness.training(ctx.config, ctx.workload)
    model, start, batches, ref = (inputs["reference"], inputs["start"], inputs["batches"],
                                  inputs["fp32"])
    start_params = {n: start[n] for n in ref["params"]}
    kw = dict(loss=t["loss"], lr=t["lr"], lovasz_weight=t["lovasz_weight"])
    with plain_float32():
        with rounding(model, "fp8"):
            readings = {"control": compare.train_numbers(train_steps(model, start, batches, **kw),
                                                         ref, start_params)}
        if faults:
            half = train_steps(model, start, [(i[: len(i) // 2], m[: len(m) // 2])
                                              for i, m in batches], **kw)
            readings["fault_half_batch"] = compare.train_numbers(half, ref, start_params)
    readings["worst_leaves"] = compare.worst_leaves(inputs["program"], ref)
    return readings


@torch.no_grad()
def serve_readings(ctx, inputs) -> dict:
    t = ctx.workload["traffic"]
    model, pool, sample = inputs["reference"], inputs["pool"], inputs["sample"]
    control, plain = {}, {}
    with plain_float32():
        for batch, served in sample:
            frames = torch.from_numpy(pool[batch]).to(ctx.device)
            with rounding(model, ctx.config["compute_dtype"]):
                exact = serve_logits(model, frames, t["model_hw"])
            with rounding(model, "fp8"):
                low = serve_logits(model, frames, t["model_hw"]).argmax(1)
            rows = nearest_index(low.shape[1], served.shape[1], low.device)
            cols = nearest_index(low.shape[2], served.shape[2], low.device)
            compare.add_served(control, compare.served_gaps(exact, low[:, rows][:, :, cols]))
            # the program against the reference in float32, for the record
            compare.add_served(plain, compare.served_gaps(
                serve_logits(model, frames, t["model_hw"]), torch.from_numpy(served).to(ctx.device)))
    return {"control": compare.served_numbers(control),
            "program_vs_float32": compare.served_numbers(plain)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--program-fault", choices=("", "half_batch"), default="")
    args = p.parse_args(argv)
    if args.program_fault:
        from tpuseg_torch.train import trainer

        trainer.make_loss_fn = half_batch_loss(trainer.make_loss_fn)
    root = harness.CHECKOUT
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    workload = harness.load_json(harness.find(root, "workloads", args.workload, ".json"))
    config = harness.load_json(harness.find(root, "configs", entry["config"], ".json"))
    driver = harness.load_module(harness.find(root, "drivers", workload["driver"], ".py"))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(name=args.workload, workload=workload, config=config, seed=seed,
                              seconds=args.seconds, trace=False, device=torch.device("cuda"),
                              chips=entry["chips"], t0=t0, root=root,
                              notes={"keep_inputs": True})
        out = driver.run(ctx)
        inputs = ctx.notes.pop("inputs")
        if workload["driver"] == "train_loop":
            readings = train_readings(ctx, inputs, faults=not args.program_fault)
        else:
            readings = serve_readings(ctx, inputs)
        print(json.dumps({"seed": seed, "program": out["numbers"], "metrics": out["metrics"],
                          "failed": out["failed"], "seconds": time.perf_counter() - t0,
                          **readings}))
        sys.stdout.flush()
        del inputs, out


if __name__ == "__main__":
    main()
