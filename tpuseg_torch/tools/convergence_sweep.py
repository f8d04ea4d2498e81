"""The convergence-protocol sweep runner: N training runs in one process.

The port's copy of ``tools/convergence_sweep.py``, with its flags, presets
and records. The loss-zoo and composed-recipe measurements are short
training runs of the synthetic protocol (``protocol_flags``: bf16, batch
64, lr 1.5e-3, 8 steps per dispatch, a 10% val split), each grid entry
run as a port ``Trainer`` in this one process (one CUDA context, the
kernels built once):

    python -m tpuseg_torch.tools.convergence_sweep [--out DIR] \\
        [--runs runs.json] [--preset loss_zoo] [--epochs 6] [--list] \\
        [--platform cpu]

``--out`` defaults to ``convergence_sweep`` under the temporary directory
(``$TMPDIR``, else the system's).

Each run writes the Trainer's checkpoint layout (<out>/<name>/
history.jsonl + best/) and one summary line to <out>/sweep.jsonl:
{"name", "flags", "ok", "seconds", "epochs", "val_miou", "car_iou"} (and
the post-eval's ``holdout_*`` scores). Idempotent: a run whose history
already holds >= --epochs entries is skipped, so a crashed sweep resumes
by running the same command again.

--runs takes a JSON list of [name, extra_flag_list] (or [name, flags,
{"eval": "imb"}]) entries layered on the protocol base config; --preset
names a built-in grid. The protocol's two arms are selected per run by
flag: balanced (the default synthetic stream) or imbalanced
(``car_prob=0.12 car_scale=0.45``). The Lovász rows (``--train.loss=
lovasz`` and ``ce+lovasz``) run the two Lovász kernels on the card. Runs
on the card unless ``--platform cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import shutil
import sys
import tempfile
import time

BAL = '[{"kind":"synthetic","num_samples":2276,"weight":1.0}]'
IMB = ('[{"kind":"synthetic","num_samples":2276,"weight":1.0,'
       '"car_prob":0.12,"car_scale":0.45}]')

# The §38 grid (reference CE baseline + every loss-zoo flag, both arms).
PRESETS = {
    "loss_zoo": [
        ["ce", []],
        ["dice", ["--train.loss=dice"]],
        ["ce_dice", ["--train.loss=ce+dice"]],
        ["lovasz", ["--train.loss=lovasz"]],
        ["ce_lovasz", ["--train.loss=ce+lovasz"]],
        ["focal", ["--train.loss=focal"]],
        ["smooth", ["--train.label_smoothing=0.1"]],
        ["ce_imb", [f"--data.sources={IMB}"]],
        ["weights_imb", [f"--data.sources={IMB}",
                         "--train.class_weights=auto"]],
        ["focal_imb", [f"--data.sources={IMB}", "--train.loss=focal"]],
    ],
    # The composed first-contact recipe vs its ingredients (VERDICT r4
    # item 1): every measured solo winner — lovász (§41), EMA (§30),
    # auto-weights-where-legal (§42), ms-TTA (§43, applied at the
    # post-eval below) — has only SOLO verdicts; this grid measures the
    # COMPOSITIONS on both protocol arms under identical seeds. Pure
    # lovász refuses class_weights by design, so the imbalanced-arm
    # weighted composition rides ce+lovasz (the CE term takes the
    # weights). Run with --eval_dir_bal/--eval_dir_imb +
    # --post_eval_tta ms to score every row's best ckpt on the SAME
    # held-out on-disk set with and without TTA.
    "composed_recipe": [
        ["ce", []],
        ["lovasz", ["--train.loss=lovasz"]],
        ["ce_lovasz", ["--train.loss=ce+lovasz"]],
        ["lovasz_ema", ["--train.loss=lovasz",
                        "--train.ema_decay=0.999"]],
        ["ce_lovasz_ema", ["--train.loss=ce+lovasz",
                           "--train.ema_decay=0.999"]],
        ["ce_imb", [f"--data.sources={IMB}"], {"eval": "imb"}],
        ["lovasz_imb", [f"--data.sources={IMB}", "--train.loss=lovasz"],
         {"eval": "imb"}],
        ["lovasz_ema_imb",
         [f"--data.sources={IMB}", "--train.loss=lovasz",
          "--train.ema_decay=0.999"], {"eval": "imb"}],
        ["ce_lovasz_w_ema_imb",
         [f"--data.sources={IMB}", "--train.loss=ce+lovasz",
          "--train.class_weights=auto", "--train.ema_decay=0.999"],
         {"eval": "imb"}],
    ],
}


def protocol_flags(name: str, epochs: int, out: str) -> list:
    """The fixed base config every run shares (the §38 protocol)."""
    return [
        "--model.compute_dtype=bfloat16",
        f"--train.epochs={epochs}",
        "--train.batch_size=64",
        "--train.lr=1.5e-3",
        "--train.steps_per_dispatch=8",
        "--data.val_split=0.1",
        f"--data.sources={BAL}",
        f"--train.checkpoint_dir={os.path.join(out, name)}",
    ]


def run_complete(hist_path: str, epochs: int) -> bool:
    if not os.path.exists(hist_path):
        return False
    with open(hist_path) as f:
        return sum(1 for _ in f) >= epochs


def last_epoch(hist_path: str) -> dict:
    """Final-epoch record; tolerant of interleaved duplicate lines from a
    recovered stall (max epoch wins, identical seeds make dups identical)."""
    best = {}
    with open(hist_path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("epoch", 0) >= best.get("epoch", 0):
                best = rec
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "convergence_sweep"))
    p.add_argument("--runs", default="",
                   help="JSON file: list of [name, [extra flags...]] pairs")
    p.add_argument("--preset", default="", choices=[""] + sorted(PRESETS))
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--list", action="store_true",
                   help="print the resolved grid and exit (no device work)")
    p.add_argument("--eval_dir_bal", default="",
                   help="held-out on-disk dataset (bdd100k layout) to score each run's "
                        "best checkpoint against after training "
                        "(tpuseg_torch.tools.export_synthetic_dataset output; "
                        "balanced-arm runs)")
    p.add_argument("--eval_dir_imb", default="",
                   help='same for runs tagged {"eval": "imb"} (the imbalanced arm: '
                        "export with --car_prob 0.12 --car_scale 0.45)")
    p.add_argument("--post_eval_tta", default="", choices=["", "flip", "ms", "flip+ms"],
                   help="also score each best checkpoint with this TTA mode; both "
                        "numbers are recorded per run")
    p.add_argument("--eval_args", default="",
                   help="extra eval_miou flags, space-separated (model/size when a "
                        "grid deviates from the protocol defaults)")
    p.add_argument("--platform", default="", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.runs:
        try:
            with open(args.runs) as f:
                grid = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            p.error(f"cannot read --runs {args.runs}: {e}")
    elif args.preset:
        grid = PRESETS[args.preset]
    else:
        p.error("pass --runs FILE or --preset NAME")
    for entry in grid:
        if (len(entry) not in (2, 3) or not isinstance(entry[0], str)
                or not isinstance(entry[1], list)
                or (len(entry) == 3 and not isinstance(entry[2], dict))):
            p.error(f"bad grid entry {entry!r}: want "
                    "[name, [flags...]] or [name, [flags...], {opts}]")

    if args.list:
        for entry in grid:
            name, extra = entry[0], entry[1]
            opts = entry[2] if len(entry) == 3 else {}
            print(json.dumps({"name": name, "extra": extra, **opts}))
        return 0

    # main's logging: the Trainer's per-epoch lines show in the sweep's log
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")

    import torch

    from tpuseg_torch.configs import load_config
    from tpuseg_torch.core.dtypes import resolve_device
    from tpuseg_torch.main import device_for_platform
    from tpuseg_torch.tools import eval_miou
    from tpuseg_torch.train.trainer import Trainer

    device = resolve_device(device_for_platform(args.platform))
    if device.type == "cuda":
        # fp32 is fp32, as the entry point sets it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    plat = ["--platform", args.platform] if args.platform else []

    def post_eval(ckdir: str, data_dir: str, tta: str):
        """Score <ckdir>/best on a held-out on-disk dir with eval_miou's own
        entry point, in this process; the parsed record, or None."""
        buf = io.StringIO()
        argv = ["--data_dir", data_dir, "--checkpoint", os.path.join(ckdir, "best")]
        if tta:
            argv += ["--tta", tta]
        argv += plat + [a for a in args.eval_args.split() if a]
        try:
            with contextlib.redirect_stdout(buf):
                rc = eval_miou.main(argv)
        except Exception as e:  # noqa: BLE001 — an eval crash must not kill the sweep
            print(f"post-eval failed: {type(e).__name__}: {e}", flush=True)
            return None
        if rc != 0:
            return None
        for line in reversed(buf.getvalue().strip().splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    return json.loads(line)
                except json.JSONDecodeError:
                    continue
        return None

    os.makedirs(args.out, exist_ok=True)
    summary_path = os.path.join(args.out, "sweep.jsonl")
    for entry in grid:
        name, extra = entry[0], entry[1]
        opts = entry[2] if len(entry) == 3 else {}
        eval_dir = args.eval_dir_imb if opts.get("eval") == "imb" else args.eval_dir_bal
        ckdir = os.path.join(args.out, name)
        hist = os.path.join(ckdir, "history.jsonl")
        if run_complete(hist, args.epochs):
            print(f"=== {name}: already complete, skip ===", flush=True)
            continue
        # a partial dir is a crashed attempt: restart it clean, so the run's
        # seeds are not half consumed
        shutil.rmtree(ckdir, ignore_errors=True)
        print(f"=== {name}: start {time.strftime('%T')} ===", flush=True)
        t0 = time.time()
        ok = True
        err = ""
        try:
            cfg = load_config(protocol_flags(name, args.epochs, args.out) + extra)
            Trainer(cfg, device=device).train()
        except Exception as e:  # noqa: BLE001 — record and continue the grid
            ok = False
            err = f"{type(e).__name__}: {e}"
            print(f"=== {name}: FAILED {err} ===", flush=True)
        rec = {"name": name, "flags": extra, "ok": ok, "seconds": round(time.time() - t0, 1)}
        if err:
            rec["error"] = err
        if ok and os.path.exists(hist):
            fin = last_epoch(hist)
            rec["epochs"] = fin.get("epoch")
            rec["val_miou"] = fin.get("val_miou")
            per = fin.get("val_iou_per_class") or []
            rec["car_iou"] = per[2] if len(per) > 2 else None
        if ok and eval_dir:
            # the held-out on-disk score (one fixture for every run) and, with
            # --post_eval_tta, the TTA-composed one
            res = post_eval(ckdir, eval_dir, "")
            if res:
                rec["holdout_miou"] = res.get("miou")
                per = res.get("iou_per_class") or []
                rec["holdout_car_iou"] = per[2] if len(per) > 2 else None
            if args.post_eval_tta:
                res_t = post_eval(ckdir, eval_dir, args.post_eval_tta)
                if res_t:
                    rec[f"holdout_miou_{args.post_eval_tta}"] = res_t.get("miou")
        with open(summary_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"=== {name}: done {rec} ===", flush=True)
    print(f"sweep summary: {summary_path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
