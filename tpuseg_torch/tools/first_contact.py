"""First-contact pipeline: the README's "when real data lands" checklist
as one command with per-step pass/fail.

The port's copy of ``tools/first_contact.py``, with its flags, refusals
and verdict JSON:

    python -m tpuseg_torch.tools.first_contact --data_dir /data/bdd100k \\
        [--val_data_dir /data/bdd100k_val] [--pth mobilenet_v2.pth] \\
        [--checkpoint_dir ckpt] [--platform cpu]

The seven steps, each the port's own entry point run in this process:

    1. reader-smoke    tools.eval_miou --limit N at a seeded init (decode,
                       LUT, resize)
    2. class-stats     tools.class_stats: pixel frequencies and the
                       suggested --train.class_weights
    3. import-pth      tools.import_pretrained of a torchvision
                       mobilenet_v2 (if --pth)
    4. train           tpuseg_torch.main on the data (EMA on, the loss
                       configurable)
    5. north-star      tools.eval_miou on held-out data (a val dir, or the
                       trainer's own seeded 10% split) with the best
                       checkpoint
    6. int8-gate       tools.eval_quantized (calibrates and scores on the
                       data)
    7. tta             tools.eval_miou --tta ms

``--platform`` passes through to every step that takes it (the card unless
``cpu``). The steps read a ``bdd100k|carla|seame`` directory, which the
port decodes with cv2 only, so the chain runs where cv2 is, not on the
card's host (ROADMAP.md A9). Prints one verdict line, {"first_contact":
{step: {"status", "detail"}}, "ok", "miou", "seconds"}; exit 0 iff every
step that ran passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time


def _train(argv) -> int:
    """``tpuseg_torch.main`` as a step (it returns the Trainer; failures raise)."""
    from tpuseg_torch.main import main

    main(argv)
    return 0


class _Tee(io.TextIOBase):
    """Mirror a step's stdout to the console while keeping a copy to parse."""

    def __init__(self, real):
        self.real = real
        self.buf = io.StringIO()

    def write(self, s):
        self.real.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.real.flush()


def _run_step(fn, argv):
    """(rc, captured stdout text); exceptions become rc=1 with the message."""
    tee = _Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(tee):
            rc = fn(argv)
    except SystemExit as e:  # argparse error paths
        rc = int(e.code or 0)
    except Exception as e:  # noqa: BLE001 — a step crash fails the step
        print(f"ERROR: {type(e).__name__}: {e}", file=sys.stderr)
        rc = 1
    return rc, tee.buf.getvalue()


def _last_json(text: str):
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_dir", required=True,
                   help="train dataset root (bdd100k layout: images/ + masks/)")
    p.add_argument("--val_data_dir", default="",
                   help="held-out val root; default: evaluate the "
                        "trainer's OWN seeded 10%% holdout of --data_dir "
                        "(eval_miou --holdout_val_split), never the "
                        "trained-on files")
    p.add_argument("--kind", default="bdd100k",
                   choices=["bdd100k", "carla", "seame"])
    p.add_argument("--pth", default="",
                   help="torchvision mobilenet_v2 .pth to import (step 3); "
                        "empty = train from a seeded init with a warning")
    p.add_argument("--checkpoint_dir", default="first_contact_ckpt")
    p.add_argument("--model", default="mobilenetv2_unet")
    p.add_argument("--base_filters", type=int, default=0)
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30,
                   help="finetune epochs (the reference trains 200 from scratch; "
                        "a pretrained encoder needs far fewer)")
    p.add_argument("--loss", default="lovasz",
                   help="default: the winner of the JAX package's composed-recipe "
                        "sweep (docs/DESIGN.md §47); ce+lovasz is the documented "
                        "alternative when label noise argues for a CE term")
    p.add_argument("--apply_weights", action="store_true",
                   help="pass step 2's suggested class weights to training "
                        "(the remedy for heavy imbalance, docs/DESIGN.md §42; "
                        "costs mIoU on balanced data)")
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--smoke_limit", type=int, default=64)
    p.add_argument("--min_miou", type=float, default=0.0,
                   help="step 5 fails below this (0 = informational)")
    p.add_argument("--skip_int8", action="store_true")
    p.add_argument("--skip_tta", action="store_true")
    p.add_argument("--platform", default="",
                   help="cuda (default) or cpu, passed to every step")
    p.add_argument("--train_args", default="",
                   help="extra tpuseg_torch.main flags, space-separated (e.g. "
                        "'--train.steps_per_dispatch=8 --train.lr=1e-4')")
    args = p.parse_args(argv)

    if args.apply_weights and args.loss in ("dice", "lovasz"):
        # the pure IoU surrogates refuse class_weights (no CE term to
        # weight: train/loss.py); failing here beats failing at step 4
        p.error(
            f"--apply_weights cannot be honored by --loss {args.loss} "
            "(no CE term); use --loss ce+lovasz (weights apply to the CE "
            "term) or drop --apply_weights — measured comparison in "
            "DESIGN §47"
        )
    from tpuseg_torch.tools import class_stats, eval_miou, eval_quantized, import_pretrained

    val_dir = args.val_data_dir or args.data_dir
    # no separate val dir: score the trainer's own held-out split (the same
    # seeded carve, eval_miou --holdout_val_split), not the whole training
    # directory, 90% of which step 4 trains on
    holdout = ([] if args.val_data_dir
               else ["--holdout_val_split", "0.1", "--holdout_seed", "42"])
    steps: "dict[str, dict]" = {}
    t_start = time.time()

    def record(name, rc, detail=""):
        status = "PASS" if rc == 0 else "FAIL"
        steps[name] = {"status": status, **({"detail": detail} if detail else {})}
        print(f"[first-contact] {name}: {status}"
              + (f" ({detail})" if detail else ""), flush=True)
        return rc == 0

    size_args = ["--width", str(args.width), "--height", str(args.height)]
    model_args = ["--model", args.model, "--num_classes",
                  str(args.num_classes), "--base_filters",
                  str(args.base_filters)]
    plat = ["--platform", args.platform] if args.platform else []

    # 1. reader smoke: decode/LUT/resize on a strided subset, random init
    rc, out = _run_step(eval_miou.main, [
        "--data_dir", args.data_dir, "--kind", args.kind,
        "--limit", str(args.smoke_limit), *size_args, *model_args, *plat,
    ])
    if not record("1-reader-smoke", rc,
                  f"{args.smoke_limit} strided images decoded"):
        _summary(steps, t_start, ok=False)
        return 1

    # 2. class statistics -> suggested weights (informational unless
    #    --apply_weights)
    rc, out = _run_step(class_stats.main, [
        "--data_dir", args.data_dir, "--kind", args.kind,
        "--samples", str(min(500, args.smoke_limit * 8)),
        "--num_classes", str(args.num_classes), *size_args,
    ])
    stats = _last_json(out)
    weights_flag = (stats or {}).get("flag", "")
    stats_ok = record("2-class-stats", rc, weights_flag or "no suggestion")
    if args.apply_weights and not (
        stats_ok and weights_flag.startswith("--train.class_weights=")
    ):
        # the user asked for the imbalance remedy; silently training
        # unweighted would defeat it
        print("[first-contact] --apply_weights requested but class stats "
              "produced no usable flag — aborting", flush=True)
        _summary(steps, t_start, ok=False)
        return 1

    # 3. pretrained encoder import
    init_ckpt = ""
    if args.pth:
        out_dir = os.path.join(args.checkpoint_dir, "pretrained")
        rc, _ = _run_step(import_pretrained.main, [
            "--pth", args.pth, "--out", out_dir, "--model", args.model,
            "--num-classes", str(args.num_classes), *plat,
        ])
        if not record("3-import-pth", rc, out_dir):
            _summary(steps, t_start, ok=False)
            return 1
        init_ckpt = out_dir
    else:
        steps["3-import-pth"] = {"status": "SKIP",
                                 "detail": "no --pth (random init)"}
        print("[first-contact] 3-import-pth: SKIP (no --pth — training "
              "from random init, like the rehearsal)", flush=True)

    # 4. train (tpuseg_torch.main, main.py's counterpart)
    img_dir = os.path.join(args.data_dir, "images")
    mask_dir = os.path.join(args.data_dir, "masks")
    sources = json.dumps([{
        "kind": args.kind, "img_dir": img_dir, "mask_dir": mask_dir,
        "weight": 1.0,
    }])
    train_argv = [
        f"--model.name={args.model}",
        f"--model.num_classes={args.num_classes}",
        f"--data.width={args.width}", f"--data.height={args.height}",
        f"--data.sources={sources}", "--data.val_split=0.1",
        f"--train.batch_size={args.batch}", f"--train.epochs={args.epochs}",
        f"--train.loss={args.loss}", f"--train.ema_decay={args.ema_decay}",
        f"--train.checkpoint_dir={args.checkpoint_dir}",
    ]
    if args.base_filters:
        train_argv.append(f"--model.base_filters={args.base_filters}")
    if init_ckpt:
        train_argv.append(f"--train.init_checkpoint={init_ckpt}")
    if args.apply_weights and weights_flag.startswith("--train.class_weights="):
        train_argv.append(weights_flag)
    if args.platform:
        train_argv.append(f"--platform={args.platform}")
    train_argv += [a for a in args.train_args.split() if a]
    rc, _ = _run_step(_train, train_argv)
    best = os.path.join(args.checkpoint_dir, "best")
    if rc == 0 and not os.path.isdir(best):
        rc = 1
    if not record("4-train", rc, f"{args.epochs} epochs -> {best}"):
        _summary(steps, t_start, ok=False)
        return 1

    # 5. the north-star number (held-out: a separate val dir, or the
    #    trainer's own 10% carve when none was given)
    rc, out = _run_step(eval_miou.main, [
        "--data_dir", val_dir, "--kind", args.kind, "--checkpoint", best,
        *holdout, *size_args, *model_args, *plat,
    ])
    res = _last_json(out) or {}
    miou = res.get("miou")
    if rc == 0 and args.min_miou and (miou or 0.0) < args.min_miou:
        rc = 1
    if not record("5-north-star", rc,
                  f"mIoU {miou:.4f}" if miou is not None else "no result"):
        _summary(steps, t_start, ok=False, miou=miou)
        return 1

    # 6. int8 deployment gate (calibration + eval on the real files)
    if args.skip_int8:
        steps["6-int8-gate"] = {"status": "SKIP"}
        print("[first-contact] 6-int8-gate: SKIP", flush=True)
        int8_ok = True
    else:
        rc, out = _run_step(eval_quantized.main, [
            "--data_dir", val_dir, "--kind", args.kind, "--checkpoint", best,
            *size_args, "--model", args.model,
            "--base_filters", str(args.base_filters), *plat,
        ])
        int8_ok = record(
            "6-int8-gate", rc,
            ("all variants within 1 mIoU pt" if rc == 0
             else "int8 delta exceeds gate — retrain with --train.qat=true")
            + ("" if args.val_data_dir else
               " [fp32-vs-int8 DELTA gate over --data_dir files: "
               "calibration wants training-distribution data]"))

    # 7. TTA option: multi-scale, the quality spend (docs/DESIGN.md §43);
    #    the chain evaluates once, so it spends it
    if args.skip_tta:
        steps["7-tta"] = {"status": "SKIP"}
        print("[first-contact] 7-tta: SKIP", flush=True)
        tta_ok = True
    else:
        rc, out = _run_step(eval_miou.main, [
            "--data_dir", val_dir, "--kind", args.kind, "--checkpoint", best,
            "--tta", "ms", *holdout, *size_args, *model_args, *plat,
        ])
        tta = (_last_json(out) or {}).get("miou")
        delta = (f"mIoU {tta:.4f} ({(tta - miou) * 100:+.2f} pts vs plain)"
                 if tta is not None and miou is not None else "no result")
        tta_ok = record("7-tta", rc, delta)

    ok = stats_ok and int8_ok and tta_ok
    _summary(steps, t_start, ok=ok, miou=miou)
    return 0 if ok else 1


def _summary(steps, t_start, ok, miou=None):
    print(json.dumps({
        "first_contact": steps, "ok": ok,
        **({"miou": round(miou, 4)} if miou is not None else {}),
        "seconds": round(time.time() - t_start, 1),
    }))


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
