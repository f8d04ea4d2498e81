"""Loss functions: (logits [B, H, W, C], targets [B, H, W]) -> scalar.

The port of ``tpuseg/train/loss.py``, with its single-device losses and its
refusals. Logits keep the JAX package's channels-last layout at these
functions; the train step hands them the model's NCHW output as an NHWC
view. Logits are promoted to at least float32 (float64 stays float64).

- ``ce``: torch ``F.cross_entropy`` semantics with ``class_weights``,
  ``label_smoothing`` and ``ignore_index``;
- ``focal`` and ``dice``;
- ``lovasz`` in three forms, chosen by ``bins``: 0 is the exact sort; 256
  is the histogram op of ``tpuseg_torch.ops.lovasz`` from the logits
  (``lovasz_logits_loss``: the two fused CUDA kernels on a CUDA tensor,
  their plain versions on a CPU tensor, and the closed-form logits
  gradient in backward); any other positive count is the level-set
  formulation of ``_binned_lovasz``;
- ``ce+dice`` and ``ce+lovasz``.

The JAX package's ``TPUSEG_LOVASZ_PALLAS`` switch is a TPU-only knob and
is not read here: at 256 bins the card always runs the kernels.

Over a mesh of more than one rank (``mesh``; ``tpuseg_torch.core.mesh``)
each rank holds its block of the global batch, rows on "data" (and H on
"spatial" with ``spatial``), and every loss is the global batch's, as the
JAX package's losses are under a data-sharded jit: CE's and focal's
weighted sums and weight sums, and dice's intersections and unions, are
summed across the ranks (one all_reduce per loss term), and the Lovász
takes ``_maybe_sharded_lovasz``'s routes.

The gradient convention, which every term obeys: each rank computes the
global loss, alike on every rank, and its backward gives this rank's
inputs (its logits) their whole gradient of that global loss, neither a
share nor a multiple of it. The collectives in the loss pass the
cotangent through unchanged (``core.mesh.sum_across``, ``gather_blocks``):
what they produce is used alike on every rank, so each rank's cotangent
there is already the whole gradient; the sharded Lovász op returns its
closed-form local gradient and all-reduces nothing in backward. A
parameter's gradient on a rank is then its part from this rank's samples,
and the train step sums those parts over the ranks (SUM all_reduce). The
one place where a global statistic feeds per-rank outputs is BatchNorm,
which sums the cross-rank terms in its own backward
(``models/blocks.py``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

from tpuseg_torch.core.mesh import gather_blocks, sum_across
from tpuseg_torch.ops.lovasz import NB, lovasz_logits_loss, make_sharded_lovasz


def _prep(logits: torch.Tensor, targets: torch.Tensor):
    """(logp [B,H,W,C], onehot [B,H,W,C], dtype); out-of-range targets
    (ignore sentinels such as 255) one-hot to an all-zero row."""
    dtype = torch.promote_types(logits.dtype, torch.float32)
    logp = torch.log_softmax(logits.to(dtype), dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (targets.to(torch.int64)[..., None] == classes).to(dtype)
    return logp, onehot, dtype


def _global(mesh, spatial: bool, *sums: torch.Tensor):
    """Local sums -> the global batch's: one all_reduce of them stacked
    (differentiable, cotangent passed through). Unchanged without a mesh."""
    group = None if mesh is None else mesh.axis_group(spatial)
    if group is None:
        return sums
    flat = sum_across(torch.cat([t.reshape(-1) for t in sums]), mesh, group)
    return [part.view_as(t) for t, part in zip(sums, flat.split([t.numel() for t in sums]))]


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
                       ignore_index: Optional[int] = None, mesh=None,
                       spatial: bool = False) -> torch.Tensor:
    """Mean per-pixel softmax cross-entropy, torch ``F.cross_entropy`` parity:

        per-pixel = (1-s) * nll * w[t] + s * (-(logp . w).sum / C)
        reduction = sum(per-pixel over valid) / sum(w[t] over valid)

    Both sums are the global batch's over ``mesh`` (see the module)."""
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
    num, den = _global(mesh, spatial, torch.sum(per_px), torch.sum(px_w))
    return num / den


def focal_loss(logits, targets, gamma: float = 2.0, class_weights=None,
               ignore_index: Optional[int] = None, mesh=None,
               spatial: bool = False) -> torch.Tensor:
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
    num, den = _global(mesh, spatial, torch.sum(per_px), torch.sum(px_w))
    return num / den


def dice_loss(logits, targets, smooth: float = 1.0, ignore_index: Optional[int] = None,
              mesh=None, spatial: bool = False) -> torch.Tensor:
    """Soft macro Dice loss ``1 - mean_c (2|p.t| + s) / (|p| + |t| + s)``."""
    logp, onehot, dtype = _prep(logits, targets)
    probs = torch.exp(logp)
    if ignore_index is not None:
        valid = (targets != ignore_index).to(dtype)[..., None]
        probs = probs * valid
        onehot = onehot * valid
    inter, p_sum, t_sum = _global(mesh, spatial, torch.sum(probs * onehot, dim=(0, 1, 2)),
                                  torch.sum(probs, dim=(0, 1, 2)),
                                  torch.sum(onehot, dim=(0, 1, 2)))
    denom = p_sum + t_sum
    dice = (2.0 * inter + smooth) / (denom + smooth)
    return 1.0 - torch.mean(dice)


def _binned_lovasz(errors: torch.Tensor, fg: torch.Tensor, bins: int, mesh=None,
                   spatial: bool = False) -> torch.Tensor:
    """The level-set Lovász of the JAX package's ``_binned_lovasz``.

    Levels t_j = j / bins for j = 0..bins; N(j), F(j), S(j) are the count,
    fg sum and error sum of the pixels with e >= t_j. The JAX scan compares
    every pixel with every threshold; here ``bucketize`` finds each pixel's
    top level L (the same float comparisons, e >= t_j iff j <= L) and the
    level sums are suffix sums of per-level histograms. So e = 1.0 sits in
    level ``bins`` of its own, as in the scan. The gradient d/de is the
    pixel's block coefficient, as autodiff of the scan gives. Over a mesh,
    ONE all_reduce of the [3, C, L] level histograms makes them the global
    batch's (the JAX route's psum of its level sums)."""
    c, _ = errors.shape
    n_levels = bins + 1
    t = torch.arange(n_levels, dtype=errors.dtype, device=errors.device) / bins
    level = torch.bucketize(errors.detach(), t, right=True) - 1     # -1: below t_0
    valid = level >= 0
    idx = (level.clamp(min=0) + n_levels * torch.arange(c, device=errors.device)[:, None])
    idx = idx[valid]
    hist = torch.stack([torch.zeros(c * n_levels, dtype=errors.dtype, device=errors.device)
                        .index_add(0, idx, v[valid]).view(c, n_levels)
                        for v in (torch.ones_like(errors), fg, errors)])
    (hist,) = _global(mesh, spatial, hist)
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
    if bins == NB:
        return lovasz_logits_loss(logits, targets, ignore_index)
    errors, fg = lovasz_errors(logits, targets, ignore_index)
    if bins > 0:
        return _binned_lovasz(errors, fg, bins)
    return _lovasz_exact(errors, fg)


def _maybe_sharded_lovasz(ignore_index: Optional[int], bins: int, mesh,
                          spatial: bool) -> Callable:
    """(logits, targets) -> the Lovász of the global batch, the routes of
    the JAX package's ``_maybe_sharded_lovasz``: without a mesh of more
    than one rank, the local loss; at 256 bins ``make_sharded_lovasz`` on
    either device (the kernels' binning, ROADMAP.md C2); at other positive
    bins the level sums all-reduced; at ``bins=0`` the exact sort over the
    global planes gathered from every rank (the JAX package's GSPMD
    semantics there)."""
    if mesh is None or mesh.size <= 1:
        return lambda lg, tg: lovasz_softmax_loss(lg, tg, ignore_index=ignore_index, bins=bins)
    if bins == NB:
        return make_sharded_lovasz(mesh, spatial=spatial, ignore_index=ignore_index)
    if bins > 0:
        return lambda lg, tg: _binned_lovasz(*lovasz_errors(lg, tg, ignore_index), bins,
                                             mesh=mesh, spatial=spatial)

    def exact(lg, tg):
        return lovasz_softmax_loss(gather_blocks(lg, mesh, spatial),
                                   gather_blocks(tg, mesh, spatial),
                                   ignore_index=ignore_index, bins=0)

    return exact


def make_loss_fn(name: str = "ce", class_weights: Optional[Sequence[float]] = None,
                 label_smoothing: float = 0.0, focal_gamma: float = 2.0,
                 dice_weight: float = 0.5, ignore_index: Optional[int] = None,
                 lovasz_bins: int = 256, mesh=None, spatial: bool = False) -> Callable:
    """Config-driven loss factory: (logits [B,H,W,C], targets [B,H,W]) -> scalar.

    ``name``: "ce" | "focal" | "dice" | "ce+dice" | "lovasz" | "ce+lovasz";
    the mixes are ``(1 - dice_weight) * CE + dice_weight * surrogate``.
    ``mesh``: over a mesh of more than one rank the loss takes this rank's
    block of the global batch (H split too with ``spatial``) and is the
    global batch's (see the module); a mesh of one rank, or none, is the
    single-process loss."""
    if mesh is not None and mesh.size <= 1:
        mesh = None
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

    over = dict(mesh=mesh, spatial=spatial)

    def ce(logits, targets):
        return cross_entropy_loss(logits, targets, class_weights=w,
                                  label_smoothing=label_smoothing,
                                  ignore_index=ignore_index, **over)

    lovasz = _maybe_sharded_lovasz(ignore_index, lovasz_bins, mesh, spatial)

    def dice(logits, targets):
        return dice_loss(logits, targets, ignore_index=ignore_index, **over)

    dw = float(dice_weight)
    if name == "ce":
        return ce
    if name == "focal":
        return lambda logits, targets: focal_loss(
            logits, targets, gamma=focal_gamma, class_weights=w, ignore_index=ignore_index,
            **over)
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
