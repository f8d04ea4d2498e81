"""Loss functions: (logits [B, H, W, C], targets [B, H, W]) -> scalar.

The port of ``tpuseg/train/loss.py``, with its single-device losses and its
refusals. Logits keep the JAX package's channels-last layout at these
functions; the train step hands them the model's NCHW output as an NHWC
view. Logits are promoted to at least float32 (float64 stays float64).

- ``ce``: torch ``F.cross_entropy`` semantics with ``class_weights``,
  ``label_smoothing`` and ``ignore_index``;
- ``focal`` and ``dice``;
- ``lovasz`` in three forms, chosen by ``bins``: 0 is the exact sort; 256
  is the histogram op of ``tpuseg_torch.ops.lovasz`` (the CUDA kernels on
  a CUDA tensor, their plain versions on a CPU tensor); any other positive
  count is the level-set formulation of ``_binned_lovasz``;
- ``ce+dice`` and ``ce+lovasz``.

The JAX package's ``TPUSEG_LOVASZ_PALLAS`` switch is a TPU-only knob and
is not read here: at 256 bins the card always runs the kernels. A mesh
(``mesh``/``spatial`` above one device) raises (ROADMAP.md A13).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

from tpuseg_torch.ops.lovasz import NB, lovasz_binned_kernel


def _prep(logits: torch.Tensor, targets: torch.Tensor):
    """(logp [B,H,W,C], onehot [B,H,W,C], dtype); out-of-range targets
    (ignore sentinels such as 255) one-hot to an all-zero row."""
    dtype = torch.promote_types(logits.dtype, torch.float32)
    logp = torch.log_softmax(logits.to(dtype), dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (targets.to(torch.int64)[..., None] == classes).to(dtype)
    return logp, onehot, dtype


def _pixel_weights(onehot, class_weights, dtype):
    if class_weights is None:
        return None, torch.ones(onehot.shape[:-1], dtype=dtype, device=onehot.device)
    w = _weights_tensor(tuple(float(x) for x in class_weights), dtype, onehot.device)
    return w, torch.sum(onehot * w, dim=-1)


@functools.lru_cache(maxsize=None)
def _weights_tensor(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The class weights on ``device``, copied there once (a captured step
    cannot copy from pageable host memory)."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def cross_entropy_loss(logits, targets, class_weights=None, label_smoothing: float = 0.0,
                       ignore_index: Optional[int] = None) -> torch.Tensor:
    """Mean per-pixel softmax cross-entropy, torch ``F.cross_entropy`` parity:

        per-pixel = (1-s) * nll * w[t] + s * (-(logp . w).sum / C)
        reduction = sum(per-pixel over valid) / sum(w[t] over valid)"""
    logp, onehot, dtype = _prep(logits, targets)
    nll = -torch.sum(logp * onehot, dim=-1)
    w, px_w = _pixel_weights(onehot, class_weights, dtype)
    s = float(label_smoothing)
    if s:
        c = logits.shape[-1]
        smooth = (-torch.sum(logp * w, dim=-1) / c if w is not None
                  else -torch.mean(logp, dim=-1))
        per_px = (1.0 - s) * nll * px_w + s * smooth
    else:
        per_px = nll * px_w
    if ignore_index is not None:
        valid = (targets != ignore_index).to(dtype)
        per_px = per_px * valid
        px_w = px_w * valid
    return torch.sum(per_px) / torch.sum(px_w)


def focal_loss(logits, targets, gamma: float = 2.0, class_weights=None,
               ignore_index: Optional[int] = None) -> torch.Tensor:
    """Multi-class focal loss ``-(1-p_t)^g * log p_t``; ``class_weights`` is
    the alpha term, applied like CE's weight."""
    logp, onehot, dtype = _prep(logits, targets)
    logp_t = torch.sum(logp * onehot, dim=-1)
    focal = (1.0 - torch.exp(logp_t)) ** float(gamma) if gamma else 1.0
    _, px_w = _pixel_weights(onehot, class_weights, dtype)
    per_px = -focal * logp_t * px_w
    if ignore_index is not None:
        valid = (targets != ignore_index).to(dtype)
        per_px = per_px * valid
        px_w = px_w * valid
    return torch.sum(per_px) / torch.sum(px_w)


def dice_loss(logits, targets, smooth: float = 1.0,
              ignore_index: Optional[int] = None) -> torch.Tensor:
    """Soft macro Dice loss ``1 - mean_c (2|p.t| + s) / (|p| + |t| + s)``."""
    logp, onehot, dtype = _prep(logits, targets)
    probs = torch.exp(logp)
    if ignore_index is not None:
        valid = (targets != ignore_index).to(dtype)[..., None]
        probs = probs * valid
        onehot = onehot * valid
    inter = torch.sum(probs * onehot, dim=(0, 1, 2))
    denom = torch.sum(probs, dim=(0, 1, 2)) + torch.sum(onehot, dim=(0, 1, 2))
    dice = (2.0 * inter + smooth) / (denom + smooth)
    return 1.0 - torch.mean(dice)


def _binned_lovasz(errors: torch.Tensor, fg: torch.Tensor, bins: int) -> torch.Tensor:
    """The level-set Lovász of the JAX package's ``_binned_lovasz``.

    Levels t_j = j / bins for j = 0..bins; N(j), F(j), S(j) are the count,
    fg sum and error sum of the pixels with e >= t_j. The JAX scan compares
    every pixel with every threshold; here ``bucketize`` finds each pixel's
    top level L (the same float comparisons, e >= t_j iff j <= L) and the
    level sums are suffix sums of per-level histograms. So e = 1.0 sits in
    level ``bins`` of its own, as in the scan. The gradient d/de is the
    pixel's block coefficient, as autodiff of the scan gives."""
    c, _ = errors.shape
    n_levels = bins + 1
    t = torch.arange(n_levels, dtype=errors.dtype, device=errors.device) / bins
    level = torch.bucketize(errors.detach(), t, right=True) - 1     # -1: below t_0
    valid = level >= 0
    idx = (level.clamp(min=0) + n_levels * torch.arange(c, device=errors.device)[:, None])
    idx = idx[valid]
    hist = [torch.zeros(c * n_levels, dtype=errors.dtype, device=errors.device)
            .index_add(0, idx, v[valid]).view(c, n_levels)
            for v in (torch.ones_like(errors), fg, errors)]
    n_lv, f_lv, s_lv = (torch.flip(torch.cumsum(torch.flip(h, [1]), 1), [1]) for h in hist)
    gts = f_lv[:, :1]
    jac = 1.0 - (gts - f_lv) / torch.clamp(gts + n_lv - f_lv, min=1.0)
    zero = torch.zeros_like(jac[:, :1])
    jac_next = torch.cat([jac[:, 1:], zero], dim=1)
    n_blk, s_blk = hist[0], hist[2]
    mean_e = s_blk / torch.clamp(n_blk, min=1.0)
    per_class = torch.sum(mean_e * (jac - jac_next), dim=-1)
    present = (gts[:, 0] > 0).to(errors.dtype)
    return torch.sum(per_class * present) / torch.clamp(present.sum(), min=1.0)


def _lovasz_exact(errors: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """The exact sort: per class, errors descending (stable) dotted with the
    gradient of the Lovász extension of the Jaccard loss."""
    errors_sorted, order = torch.sort(errors, dim=-1, descending=True, stable=True)
    fg_sorted = torch.gather(fg, -1, order)
    gts = torch.sum(fg_sorted, dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(fg_sorted, dim=-1)
    union = gts + torch.cumsum(1.0 - fg_sorted, dim=-1)
    jaccard = 1.0 - intersection / union
    grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=-1)
    per_class = torch.sum(errors_sorted * grad, dim=-1)
    present = (gts[:, 0] > 0).to(errors.dtype)
    return torch.sum(per_class * present) / torch.clamp(present.sum(), min=1.0)


def lovasz_errors(logits, targets, ignore_index: Optional[int] = None):
    """(errors, fg), each [C, B*H*W] contiguous: |1{y=c} - p_c| and the
    one-hot targets, with ignored pixels at error 0 and label 0."""
    logp, onehot, dtype = _prep(logits, targets)
    c = logits.shape[-1]
    fg = onehot.reshape(-1, c).t()
    errors = torch.abs(fg - torch.exp(logp).reshape(-1, c).t())
    if ignore_index is not None:
        valid = (targets != ignore_index).to(dtype).reshape(1, -1)
        fg = fg * valid
        errors = errors * valid
    return errors.contiguous(), fg.contiguous()


def lovasz_softmax_loss(logits, targets, ignore_index: Optional[int] = None,
                        bins: int = 0) -> torch.Tensor:
    """Lovász-softmax loss (Berman et al., CVPR 2018), classes="present",
    the batch flattened per class."""
    errors, fg = lovasz_errors(logits, targets, ignore_index)
    if bins == NB:
        return lovasz_binned_kernel(errors, fg)
    if bins > 0:
        return _binned_lovasz(errors, fg, bins)
    return _lovasz_exact(errors, fg)


def make_loss_fn(name: str = "ce", class_weights: Optional[Sequence[float]] = None,
                 label_smoothing: float = 0.0, focal_gamma: float = 2.0,
                 dice_weight: float = 0.5, ignore_index: Optional[int] = None,
                 lovasz_bins: int = 256, mesh=None, spatial: bool = False) -> Callable:
    """Config-driven loss factory: (logits [B,H,W,C], targets [B,H,W]) -> scalar.

    ``name``: "ce" | "focal" | "dice" | "ce+dice" | "lovasz" | "ce+lovasz";
    the mixes are ``(1 - dice_weight) * CE + dice_weight * surrogate``."""
    if (mesh is not None and getattr(mesh, "size", 1) > 1) or spatial:
        raise NotImplementedError(
            "a loss over a multi-device mesh is not ported yet (ROADMAP.md A13, multi-GPU)"
        )
    w = None if class_weights is None else tuple(float(x) for x in class_weights)
    name = (name or "ce").lower()
    if name in ("dice", "lovasz"):
        if w is not None:
            raise ValueError(
                f"loss {name!r} has no cross-entropy term and cannot honor "
                "class_weights; use 'ce+" + name + "' (weights apply to the "
                "CE term) or drop --train.class_weights"
            )
        if label_smoothing:
            raise ValueError(
                f"loss {name!r} cannot honor label_smoothing; use "
                "'ce+" + name + "' or drop --train.label_smoothing"
            )
    if name == "focal" and label_smoothing:
        raise ValueError(
            "loss 'focal' has no label-smoothing term; drop "
            "--train.label_smoothing (focal's alpha term is class_weights)"
        )

    def ce(logits, targets):
        return cross_entropy_loss(logits, targets, class_weights=w,
                                  label_smoothing=label_smoothing,
                                  ignore_index=ignore_index)

    def lovasz(logits, targets):
        return lovasz_softmax_loss(logits, targets, ignore_index=ignore_index,
                                   bins=lovasz_bins)

    def dice(logits, targets):
        return dice_loss(logits, targets, ignore_index=ignore_index)

    dw = float(dice_weight)
    if name == "ce":
        return ce
    if name == "focal":
        return lambda logits, targets: focal_loss(
            logits, targets, gamma=focal_gamma, class_weights=w, ignore_index=ignore_index)
    if name == "dice":
        return dice
    if name in ("ce+dice", "dice+ce"):
        return lambda logits, targets: (1.0 - dw) * ce(logits, targets) + dw * dice(
            logits, targets)
    if name == "lovasz":
        return lovasz
    if name in ("ce+lovasz", "lovasz+ce"):
        return lambda logits, targets: (1.0 - dw) * ce(logits, targets) + dw * lovasz(
            logits, targets)
    raise ValueError(
        f"unknown loss {name!r}: expected ce|focal|dice|ce+dice|lovasz|ce+lovasz"
    )
