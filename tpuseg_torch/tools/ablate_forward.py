"""Forward-pass time breakdown on the card: nested prefixes of the flagship.

The port's copy of ``tools/ablate_forward.py``, with its flags and output.
Each row runs a prefix of the flagship inference program (bf16 compute,
``--size`` x ``--size``, ``--batch`` images) and reduces it to a scalar:

    encoder    the five taps (their sum)
    decoder    + up1..up4 and outc: the logits at half size (their sum)
    final_up   + the final x2 align_corners upsample in fp32 (its sum)
    argmax     + the class argmax (the sum of the picks): the whole
               serving forward

The deltas between rows attribute time to each stage. Every prefix calls
the full model's own submodules (``backbone``, ``up1..up4``, ``outc``), so
each binds the model's parameters, as the JAX ``Partial`` does; the decoder
takes the plain ops (``--subpixel 1``: the subpixel rewrite, the model
default; 0: the materialized upsample and concat), not the fused kernel,
as the JAX tool builds ``Up`` without ``use_pallas``.

On the card each prefix is one CUDA graph (``core/graphs.py``), replayed
``--chain`` times between two CUDA events: the counterpart of the JAX
tool's jitted ``lax.scan`` chain. On the CPU (``--platform cpu``) it runs
eager, timed by the host clock: such a time is the CPU's, not the card's.

    python -m tpuseg_torch.tools.ablate_forward [--batch 64] [--size 512] \\
        [--chain 16] [--subpixel 1] [--platform cpu]

Prints one line per row and last {"ms_per_iter": {row: ms}, "batch": B}.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

STAGES = ("encoder", "decoder", "final_up", "argmax")


def prefix(model: nn.Module, stage: str, subpixel: bool = True) -> Callable:
    """``x`` (NCHW) -> the float32 scalar of the forward up to ``stage``."""
    from tpuseg_torch.ops.resize import upsample2x_bilinear

    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {STAGES}")

    def fwd(x: torch.Tensor) -> torch.Tensor:
        taps = model.backbone(x)
        if stage == "encoder":
            return sum(t.float().sum() for t in taps)
        x1, x2, x3, x4, x5 = taps
        y = model.up1(x5, x4, subpixel=subpixel)
        y = model.up2(y, x3, subpixel=subpixel)
        y = model.up3(y, x2, subpixel=subpixel)
        y = model.up4(y, x1, subpixel=subpixel)
        y = model.outc(y).float()
        if stage == "decoder":
            return y.sum()
        y = upsample2x_bilinear(y.permute(0, 2, 3, 1), align_corners=True)
        if stage == "final_up":
            return y.sum()
        return y.argmax(dim=-1).sum().float()

    return fwd


def chain_ms(fn: Callable, args: Tuple, chain: int, name: str):
    """(ms per call of ``fn(*args)`` over ``chain`` calls, the output of
    the last). On the card: one captured graph (``fn`` itself when it is a
    ``graphs.Captured`` already), replayed ``chain`` times between CUDA
    events; on the CPU: eager, after one warm-up call, on the host clock."""
    from tpuseg_torch.core import graphs

    if args[0].device.type != "cuda":
        fn(*args)
        t0 = time.perf_counter()
        for _ in range(chain):
            out = fn(*args)
        return (time.perf_counter() - t0) * 1e3 / chain, out
    step = fn if isinstance(fn, graphs.Captured) else graphs.Captured(fn, name)
    step(*args)                 # warm-up and capture
    step(*args)                 # one replay before the clock
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(chain):
        out = step(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / chain, out


def build(batch: int, size: int, device) -> Tuple[nn.Module, torch.Tensor]:
    """The flagship (10 classes, bf16 compute, seeded init) in eval mode on
    ``device``, and the seeded input ``x`` [batch, 3, size, size] (an NCHW
    view of NHWC memory: channels_last, the layout the port serves in)."""
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.models.registry import build_model

    model = build_model(ModelConfig(name="mobilenetv2_unet", compute_dtype="bfloat16"))
    model.to(device, memory_format=torch.channels_last).eval()
    x = torch.from_numpy(np.random.RandomState(0).rand(batch, size, size, 3).astype(np.float32))
    return model, x.to(device).permute(0, 3, 1, 2)


def ablate(model: nn.Module, x: torch.Tensor, chain: int,
           subpixel: bool = True) -> Dict[str, Tuple[float, float]]:
    """{stage: (ms per call, the prefix's value)} for every stage."""
    out = {}
    with torch.no_grad():
        for stage in STAGES:
            ms, value = chain_ms(prefix(model, stage, subpixel), (x,), chain,
                                 f"ablate_forward_{stage}")
            out[stage] = (ms, float(value))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--chain", type=int, default=16)
    p.add_argument("--subpixel", type=int, default=1,
                   help="decoder subpixel rewrite (model default: on)")
    p.add_argument("--platform", default="", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from tpuseg_torch.core.dtypes import resolve_device
    from tpuseg_torch.main import device_for_platform

    device = resolve_device(device_for_platform(args.platform))
    if device.type == "cuda":
        # fp32 is fp32, as the entry points set it (the final upsample)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model, x = build(args.batch, args.size, device)
    results = {}
    for stage, (ms, _) in ablate(model, x, args.chain, bool(args.subpixel)).items():
        results[stage] = round(ms, 3)
        print(f"{stage}: {ms:.3f} ms/iter ({args.batch / (ms / 1e3):.0f} imgs/s)", flush=True)
    print(json.dumps({"ms_per_iter": results, "batch": args.batch}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
