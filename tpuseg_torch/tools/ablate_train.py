"""Train-step time breakdown on the card: nested pieces of the train step.

The port's copy of ``tools/ablate_train.py``, with its flags and output
(the counterpart of ``ablate_forward`` for training). Rows, on the
flagship at ``--width`` x ``--height``, ``--batch`` images, ``--dtype``
compute, against seeded labels:

    fwd_eval     forward (BatchNorm on its running statistics) + CE loss
    fwd_train    forward with batch statistics (train mode) + CE loss
    grad_evalbn  loss and gradients, BatchNorm in eval mode
    grad         loss and gradients, BatchNorm in train mode (the real
                 backward)
    full         the port's train step (``make_train_step``: forward,
                 backward, Adam update, BatchNorm statistics)

(fwd_train - fwd_eval) is the BatchNorm statistics' cost, (grad -
fwd_train) the backward's, (full - grad) the optimizer's. The gradient
rows consume every gradient leaf (their sum, scaled by 1e-20, joins the
value), as the JAX tool does so that XLA keeps the backward. The rows
before ``full`` leave the model as it was (the running statistics do not
move); ``full`` advances it a step per call, as the JAX chain does.

On the card each row is one CUDA graph (``core/graphs.py``; ``full`` is
the train step's own captured graph), replayed ``--chain`` times between
two CUDA events: the counterpart of the JAX tool's jitted ``lax.scan``
chain. On the CPU (``--platform cpu``) it runs eager on the host clock.

    python -m tpuseg_torch.tools.ablate_train [--batch 64] [--width 256] \\
        [--height 128] [--dtype bfloat16] [--chain 8] [--platform cpu]

Prints one line per row and last {"ms_per_iter": {row: ms}, "batch": B,
"size": [H, W]}.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from tpuseg_torch.tools.ablate_forward import chain_ms

ROWS = ("fwd_eval", "fwd_train", "grad_evalbn", "grad")


def row_fn(model: nn.Module, row: str) -> Callable:
    """``(images NHWC, labels) -> float32 scalar`` of one row (not ``full``)."""
    from tpuseg_torch.models.blocks import frozen_running_stats
    from tpuseg_torch.train.loss import cross_entropy_loss
    from tpuseg_torch.train.train_step import forward_nhwc

    if row not in ROWS:
        raise ValueError(f"unknown row {row!r}; one of {ROWS} or 'full'")
    train = row in ("fwd_train", "grad")
    params = [p for p in model.parameters() if p.requires_grad]

    def loss_of(x, y):
        model.train(train)
        with frozen_running_stats():
            return cross_entropy_loss(forward_nhwc(model, x), y)

    def fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if row.startswith("fwd"):
            with torch.no_grad():
                return loss_of(x, y).detach()
        loss = loss_of(x, y)
        grads = torch.autograd.grad(loss, params)
        gsum = sum(g.float().sum() for g in grads)
        return (loss + gsum * 1e-20).detach()

    return fn


def build(batch: int, height: int, width: int, dtype: str,
          device) -> Tuple[nn.Module, torch.Tensor, torch.Tensor]:
    """The flagship (10 classes, seeded init) on ``device``, seeded images
    [batch, height, width, 3] float32 and labels [batch, height, width]."""
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.models.registry import build_model

    model = build_model(ModelConfig(name="mobilenetv2_unet", compute_dtype=dtype))
    model.to(device, memory_format=torch.channels_last)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, height, width, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (batch, height, width)).astype(np.int64))
    return model, x.to(device), y.to(device)


def full_step(model: nn.Module) -> Callable:
    """The port's train step (Adam, the reference's defaults, plain CE):
    ``(images, labels) -> {"loss"}``, its own captured graph on the card."""
    from tpuseg_torch.train.optim import Optimizer
    from tpuseg_torch.train.train_step import make_train_step

    return make_train_step(model, Optimizer(list(model.parameters())))


def ablate(model: nn.Module, x: torch.Tensor, y: torch.Tensor,
           chain: int) -> Dict[str, Tuple[float, float]]:
    """{row: (ms per call, the last call's value)}, ``full`` last."""
    out = {}
    for row in ROWS:
        ms, value = chain_ms(row_fn(model, row), (x, y), chain, f"ablate_train_{row}")
        out[row] = (ms, float(value))
    ms, value = chain_ms(full_step(model), (x, y), chain, "ablate_train_full")
    out["full"] = (ms, float(value["loss"]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--chain", type=int, default=8)
    p.add_argument("--platform", default="", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from tpuseg_torch.core.dtypes import resolve_device
    from tpuseg_torch.main import device_for_platform

    device = resolve_device(device_for_platform(args.platform))
    if device.type == "cuda":
        # fp32 is fp32, as the entry points set it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model, x, y = build(args.batch, args.height, args.width, args.dtype, device)
    results = {}
    for row, (ms, _) in ablate(model, x, y, args.chain).items():
        results[row] = round(ms, 3)
        print(f"{row}: {ms:.3f} ms/iter ({args.batch / (ms / 1e3):.0f} imgs/s)", flush=True)
    print(json.dumps({"ms_per_iter": results, "batch": args.batch,
                      "size": [args.height, args.width]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
