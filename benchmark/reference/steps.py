"""The plain reference of what the timed paths compute: the loss, the train
steps with Adam, and the served forward.

Float32 throughout, with TF32 off for cuDNN and matmuls (``plain_float32``).
Imports nothing of the program. The losses follow the configurations:

- ``ce``: the mean per-pixel softmax cross-entropy (``F.cross_entropy``);
- ``lovasz``: Lovász-softmax (Berman et al., CVPR 2018), classes present in
  the batch, the batch flattened per class, sort-free over 256 bins: a
  pixel's bin is ``min(trunc(e * 256), 255)`` of its error ``|1{y=c} -
  p_c|``; per class and bin the count and foreground sum give the Jaccard
  at each level, and each pixel's error is weighted by its bin's Jaccard
  step over the bin's count, so the loss is the mean error of each level
  set times the Jaccard step there, and its gradient in the errors is that
  weight (the weights are constants of the batch);
- ``ce+lovasz``: ``(1 - w) * ce + w * lovasz`` with the configured weight.

Adam is Kingma and Ba's, with the bias correction at step t and ``eps``
outside the square root.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BINS = 256
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def plain_float32():
    """float32 convolutions and matmuls, TF32 off, for the block."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized float32 NCHW."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def lovasz(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binned Lovász-softmax of NCHW logits against [B, H, W] targets."""
    c = logits.shape[1]
    probs = torch.softmax(logits, dim=1)
    fg = F.one_hot(targets, c).permute(0, 3, 1, 2).to(probs.dtype)
    errors = (fg - probs).abs().transpose(0, 1).reshape(c, -1)
    fg = fg.transpose(0, 1).reshape(c, -1)
    with torch.no_grad():
        bins = torch.clamp(errors * BINS, max=BINS - 1).to(torch.int64)
        idx = (bins + BINS * torch.arange(c, device=errors.device)[:, None]).reshape(-1)
        count = torch.zeros(c * BINS, dtype=torch.float64, device=errors.device)
        count.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float64))
        fgsum = torch.zeros_like(count).index_add_(0, idx, fg.reshape(-1).to(torch.float64))
        count, fgsum = count.view(c, BINS), fgsum.view(c, BINS)
        n_cum = torch.flip(torch.cumsum(torch.flip(count, [1]), 1), [1])
        f_cum = torch.flip(torch.cumsum(torch.flip(fgsum, [1]), 1), [1])
        gts = f_cum[:, :1]
        jac = 1.0 - (gts - f_cum) / torch.clamp(gts + n_cum - f_cum, min=1.0)
        step = jac - torch.cat([jac[:, 1:], torch.zeros_like(jac[:, :1])], dim=1)
        present = (gts[:, 0] > 0).to(torch.float64)
        weight = step / torch.clamp(count, min=1.0) * (present / present.sum().clamp(min=1.0))[:, None]
        pixel_weight = weight.reshape(-1)[idx].to(errors.dtype)
    return torch.sum(errors.reshape(-1) * pixel_weight)


def loss_fn(kind: str, lovasz_weight: float = 0.5):
    """The configured loss of NCHW logits and int64 targets."""
    if kind == "ce":
        return lambda lg, t: F.cross_entropy(lg, t)
    if kind == "lovasz":
        return lovasz
    if kind == "ce+lovasz":
        return lambda lg, t: ((1.0 - lovasz_weight) * F.cross_entropy(lg, t)
                              + lovasz_weight * lovasz(lg, t))
    raise KeyError(f"no reference loss {kind!r}")


def train_steps(model: nn.Module, state: Dict[str, torch.Tensor],
                batches: Iterable[Tuple[torch.Tensor, torch.Tensor]], loss: str,
                lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                lovasz_weight: float = 0.5) -> Dict[str, object]:
    """Train ``model`` from ``state`` on ``batches`` of (uint8 NHWC images,
    uint8 masks), one Adam step each, BatchNorm on batch statistics.

    Returns the losses, both moments and the parameters after the last
    step, by parameter name."""
    model.load_state_dict(state)
    model.train()
    compute = loss_fn(loss, lovasz_weight)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    losses: List[float] = []
    for t, (images, masks) in enumerate(batches, start=1):
        value = compute(model(normalize(images)), masks.to(torch.int64))
        grads = torch.autograd.grad(value, params)
        losses.append(float(value.detach()))
        with torch.no_grad():
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
    return {"losses": losses, "mu": dict(zip(names, mu)), "nu": dict(zip(names, nu)),
            "params": {n: p.detach().clone() for n, p in zip(names, params)}}


def _model_input(frames_u8: torch.Tensor, model_hw: Sequence[int]) -> torch.Tensor:
    x = frames_u8.to(torch.float32).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(model_hw), mode="bilinear", align_corners=False)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return (x / 255.0 - mean) / std


@torch.no_grad()
def settle_batchnorm(model: nn.Module, frames_u8: torch.Tensor, model_hw: Sequence[int]) -> None:
    """Every BatchNorm's running statistics set to the batch statistics of
    ``frames`` as served, as a trained model's match its inputs."""
    norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None           # a cumulative average: one batch's statistics
    model.train()
    model(_model_input(frames_u8, model_hw))
    for m in norms:
        m.momentum = 0.1


@torch.no_grad()
def serve_logits(model: nn.Module, frames_u8: torch.Tensor,
                 model_hw: Sequence[int]) -> torch.Tensor:
    """uint8 NHWC frames -> NCHW float32 logits at the model size: the
    half-pixel bilinear resize, the normalize, the eval forward."""
    model.eval()
    return model(_model_input(frames_u8, model_hw))


def nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """The source index of each of ``n_out`` nearest-upscaled positions:
    floor(i * n_in / n_out), in integers."""
    return torch.arange(n_out, device=device) * n_in // n_out
