"""The sort-free Lovász-softmax loss: its CUDA kernels, their plain
versions, and the autograd ops built on them.

The port of ``tpuseg/ops/lovasz_pallas.py``:

========================  ===========================  ===============================
wrapper                   CUDA source (tpuseg_torch/)  plain PyTorch version
========================  ===========================  ===============================
lovasz_logits_histograms  csrc/lovasz_logits.cu        lovasz_logits_histograms_plain
lovasz_logits_grad        csrc/lovasz_logits.cu        lovasz_logits_grad_plain
lovasz_histograms         csrc/lovasz_histograms.cu    lovasz_histograms_plain
lovasz_lookup             csrc/lovasz_lookup.cu        lovasz_lookup_plain
========================  ===========================  ===============================

The training paths run the region of ``lovasz_pallas.make_sharded_lovasz``
from the logits to their gradient as two fused kernels
(``lovasz_logits_parts``): ``lovasz_logits_histograms`` reads the logits
and targets once and gives the [3, C, 256] histograms (count, fg sum,
error sum); over ranks one all_reduce sums them; ``lovasz_logits_grad``
computes the per-bin coefficients and the loss value in one block, then
recomputes each pixel's softmax and writes the closed-form logits
gradient. No [C, P] plane is ever written. ``make_sharded_lovasz(mesh)``
and, on one card, ``lovasz_logits_loss`` (``lovasz_softmax_loss`` at 256
bins) are the same autograd op: forward runs both kernels and saves the
gradient, backward returns g times it.

The two plane kernels are the ports of the TPU kernels themselves
(``_histograms`` and ``_lookup``) and take [C, P] error and foreground
planes: ``lovasz_binned_kernel(errors, fg)`` is ``lovasz_binned_pallas``,
and ``sharded_lovasz_parts`` composes the region from them (or from their
plain versions) as the port ran it before the fused kernels. No training
path runs them now; they stay, and are held against the fused route.

The binning is the TPU kernel's, on every route: a pixel's bin is
``clip(trunc(e * 256), 0, 255)``, so e = 1.0 falls in bin 255, and a
pixel with e < 0 enters no bin. (The JAX package's XLA scan,
``tpuseg/train/loss.py::_binned_lovasz``, gives e = 1.0 a level of its
own; the two agree wherever no error is exactly 1.0.)

Dispatch goes by the tensor's device, as in ``ops/kernels.py``: a CPU
tensor runs the plain version; a CUDA tensor launches the kernel or
raises. Each launch adds one to ``kernels.launches[<wrapper name>]``.
The kernels' designs and bounds are in their sources' headers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional

import torch

from tpuseg_torch.core.mesh import all_reduce_
from tpuseg_torch.ops.kernels import (_c_fn, _launch, _on_cuda, _require_contiguous,
                                      launches)

NB = 256
_THREADS = 256


def _check_plane(name: str, t: torch.Tensor) -> None:
    if t.ndim != 2:
        raise ValueError(f"{name} must be [C, P], got {tuple(t.shape)}")


def _flat_bins(errors: torch.Tensor) -> torch.Tensor:
    """int64 index c * 256 + bin of each pixel into the flattened [C, 256]
    histograms, and C * 256 (one slot past them) where e < 0. Fixed shapes
    and no host sync, so the plain versions can be captured in a CUDA graph."""
    c = errors.shape[0]
    b = torch.clamp(errors * NB, max=NB - 1).to(torch.int64).clamp_(min=0)
    idx = b + NB * torch.arange(c, device=errors.device)[:, None]
    return torch.where(errors >= 0, idx, torch.full_like(idx, c * NB))


# ---------------------------------------------------------------------------
# histograms


def lovasz_histograms_plain(errors: torch.Tensor, fg: torch.Tensor):
    """Plain version: (count, fg-sum, error-sum) histograms, each [C, 256].
    Summed in float64 and rounded once to the input's type, so counts and
    fg sums are the exact totals rounded, at any P (a float32 sum of ones
    stops at 2**24)."""
    c = errors.shape[0]
    idx = _flat_bins(errors).reshape(1, -1).expand(3, -1)
    vals = torch.stack([torch.ones_like(errors), fg, errors]).reshape(3, -1)
    out = torch.zeros((3, c * NB + 1), dtype=torch.float64, device=errors.device)
    out.scatter_add_(1, idx, vals.to(torch.float64))
    h = out[:, : c * NB].view(3, c, NB).to(errors.dtype)
    return h[0], h[1], h[2]


def lovasz_hist_plan(c: int, p: int, sms: int) -> int:
    """Histogram blocks per class for [C, P] planes on a card with ``sms``
    SMs. The rule is the kernel's own (``tpuseg_lovasz_hist_plan``): the
    grid fills the card's resident slots once, and each block holds fewer
    than 2**23 pixels, which keeps its float partials of 0s and 1s exact."""
    nblk = ctypes.c_int()
    rc = _c_fn("lovasz_hist_plan")(c, p, sms, ctypes.byref(nblk))
    if rc != 0:
        raise RuntimeError(f"lovasz histogram plan failed: CUDA error {rc}")
    return nblk.value


def lovasz_histograms(errors: torch.Tensor, fg: torch.Tensor):
    """Per class, per bin: pixel count, fg sum and error sum.

    errors, fg [C, P] -> three [C, 256] tensors. On a CUDA tensor the
    kernel runs in two passes (per-block partials in shared memory, then a
    fixed-order reduction in double); counts and fg sums are the exact
    totals rounded once, as the plain version's; the error sum is summed in
    another order than the plain version's."""
    _check_plane("errors", errors)
    if fg.shape != errors.shape:
        raise ValueError(f"fg {tuple(fg.shape)} and errors {tuple(errors.shape)} differ")
    if not _on_cuda(errors, fg):
        return lovasz_histograms_plain(errors, fg)
    _require_contiguous(errors=errors, fg=fg)
    c, p = errors.shape
    sms = torch.cuda.get_device_properties(errors.device).multi_processor_count
    nblk = lovasz_hist_plan(c, p, sms)
    partial = torch.empty((c, nblk, 3, NB), dtype=torch.float32, device=errors.device)
    hist = torch.empty((c, 3, NB), dtype=torch.float32, device=errors.device)
    _launch("lovasz_histograms", errors.device, errors.data_ptr(), fg.data_ptr(),
            partial.data_ptr(), hist.data_ptr(), c, p, nblk)
    launches["lovasz_histograms"] += 1
    return hist[:, 0], hist[:, 1], hist[:, 2]


# ---------------------------------------------------------------------------
# coefficients (plain tensor ops on [C, 256], shared by both routes)


def coefficients(h_n: torch.Tensor, h_f: torch.Tensor, h_s: torch.Tensor):
    """Per-bin coefficients coef[c, b] = delta-Jaccard / bin count, scaled by
    the mean over present classes, and the loss value from the error-sum
    histogram. The arithmetic of ``lovasz_pallas._coefficients``."""
    n_cum = torch.flip(torch.cumsum(torch.flip(h_n, [1]), 1), [1])
    f_cum = torch.flip(torch.cumsum(torch.flip(h_f, [1]), 1), [1])
    gts = f_cum[:, :1]
    jac = 1.0 - (gts - f_cum) / torch.clamp(gts + n_cum - f_cum, min=1.0)
    jac_next = torch.cat([jac[:, 1:], torch.zeros_like(jac[:, :1])], dim=1)
    delta = jac - jac_next
    present = (gts[:, 0] > 0).to(jac.dtype)
    scale = present / torch.clamp(present.sum(), min=1.0)
    per_bin = delta / torch.clamp(h_n, min=1.0) * scale[:, None]
    return per_bin, torch.sum(h_s * per_bin)


# ---------------------------------------------------------------------------
# lookup


def lovasz_lookup_plain(errors: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Plain version: w[c, p] = coef[c, bin(e)], 0 where e < 0."""
    flat = torch.cat([coef.reshape(-1), coef.new_zeros(1)])
    return flat[_flat_bins(errors)]


def lovasz_lookup(errors: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """errors [C, P], coef [C, 256] -> w [C, P] (the per-pixel gradient)."""
    _check_plane("errors", errors)
    if tuple(coef.shape) != (errors.shape[0], NB):
        raise ValueError(f"coef must be [{errors.shape[0]}, {NB}], got {tuple(coef.shape)}")
    if not _on_cuda(errors, coef):
        return lovasz_lookup_plain(errors, coef)
    _require_contiguous(errors=errors, coef=coef)
    c, p = errors.shape
    nblk = max(1, min(1024, -(-p // (_THREADS * 8))))
    w = torch.empty_like(errors)
    _launch("lovasz_lookup", errors.device, errors.data_ptr(), coef.data_ptr(),
            w.data_ptr(), c, p, nblk)
    launches["lovasz_lookup"] += 1
    return w


# ---------------------------------------------------------------------------
# the loss op


def _forward(errors, fg, histograms, lookup):
    coef, value = coefficients(*histograms(errors, fg))
    return value, lookup(errors, coef)


class _LovaszBinned(torch.autograd.Function):
    """Value from the histograms; d value / d errors = w; fg is constant."""

    @staticmethod
    def forward(ctx, errors, fg, histograms, lookup):
        value, w = _forward(errors, fg, histograms, lookup)
        ctx.save_for_backward(w)
        return value

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g * w, None, None, None


def lovasz_binned_kernel(errors: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """Binned Lovász-softmax from [C, P] errors and foreground: a scalar,
    differentiable in ``errors`` (the port of ``lovasz_binned_pallas``)."""
    return _LovaszBinned.apply(errors, fg, lovasz_histograms, lovasz_lookup)


def lovasz_binned_plain(errors: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """The same op built on the plain versions, on any device (for
    comparing the kernels with their plain versions on the card)."""
    return _LovaszBinned.apply(errors, fg, lovasz_histograms_plain, lovasz_lookup_plain)




# ---------------------------------------------------------------------------
# the region from the logits: the [C, P] planes and the closed-form gradient


def _planes(logits: torch.Tensor, targets: torch.Tensor, ignore_index: Optional[int]):
    """(probs [b,h,w,C], pr [C, P], fg [C, P], errors [C, P], valid [1, P] or
    None) of this block of logits and targets: the plain steps of the
    region of ``lovasz_pallas.make_sharded_lovasz`` before its kernels. fg
    and errors are contiguous, with ignored pixels at error 0 and label 0."""
    dtype = torch.promote_types(logits.dtype, torch.float32)
    c = logits.shape[-1]
    probs = torch.exp(torch.log_softmax(logits.to(dtype), dim=-1))
    classes = torch.arange(c, device=logits.device)
    onehot = (targets.to(torch.int64)[..., None] == classes).to(dtype)
    fg = onehot.reshape(-1, c).t()
    pr = probs.reshape(-1, c).t()
    errors = torch.abs(fg - pr)
    valid = None
    if ignore_index is not None:
        valid = (targets != ignore_index).to(dtype).reshape(1, -1)
        fg = fg * valid
        errors = errors * valid
    return probs, pr, fg.contiguous(), errors.contiguous(), valid


def _class_sum(wp: torch.Tensor) -> torch.Tensor:
    """The sum of wp [..., C] over its classes in the fused kernels' fixed
    order (torch.sum's order depends on the layout and the build). Up to 32
    classes in class order. Above, in the order of torch's warp softmax sum:
    lane j of 32 sums classes j, j + 32, ... in order from zero, then the
    lanes' sums fold pairwise (j + 16 onto j, then j + 8, ...)."""
    c = wp.shape[-1]
    if c <= 32:
        total = wp[..., 0]
        for k in range(1, c):
            total = total + wp[..., k]
        return total
    rows = -(-c // 32)
    lanes = torch.nn.functional.pad(wp, (0, 32 * rows - c)).unflatten(-1, (rows, 32))
    total = torch.zeros_like(lanes[..., 0, :])
    for i in range(rows):
        total = total + lanes[..., i, :]
    width = 16
    while width:
        total = total[..., :width] + total[..., width:2 * width]
        width //= 2
    return total[..., 0]


def _closed_form(w, pr, fg, valid, probs) -> torch.Tensor:
    """dL/dz_k = wt_k p_k - p_k sum_c wt_c p_c with wt = w sign(p - fg)
    valid: the product autodiff builds from sum |fg - p| * w, w constant,
    its class sum in the fused kernels' order (``_class_sum``)."""
    wt = w * torch.sign(pr - fg)
    if valid is not None:
        wt = wt * valid
    wp = wt.t().reshape(probs.shape) * probs
    return wp - probs * _class_sum(wp)[..., None]


def sharded_lovasz_parts(logits: torch.Tensor, targets: torch.Tensor, mesh, spatial: bool,
                         ignore_index: Optional[int], histograms, lookup):
    """(value, coef, grad) of the Lovász over the mesh's global batch, from
    this rank's block of logits [b, h, w, C] and targets [b, h, w], composed
    of the plane kernels ``histograms`` and ``lookup`` (or their plain
    versions): the region of ``lovasz_pallas.make_sharded_lovasz`` step by
    step, as the port ran it before the fused kernels. The training paths
    run ``lovasz_logits_parts``; this composition stays to hold the plane
    kernels and the fused route against each other.

    The local [C, P] planes give local histograms; ONE all_reduce of the
    three, stacked into one [3, C, 256] buffer, over the data axis (the
    whole mesh with ``spatial``) makes them the global batch's; the
    coefficients and the value follow on every rank alike; the local
    lookup gives w, and the logits gradient is the closed form."""
    probs, pr, fg, errors, valid = _planes(logits, targets, ignore_index)
    hist = torch.stack(histograms(errors, fg))                # [3, C, 256]
    all_reduce_(hist, mesh, None if mesh is None else mesh.axis_group(spatial))
    coef, value = coefficients(hist[0], hist[1], hist[2])
    w = lookup(errors, coef.contiguous())                     # [C, P]
    return value, coef, _closed_form(w, pr, fg, valid, probs)


def lovasz_logits_histograms_plain(logits: torch.Tensor, targets: torch.Tensor,
                                   ignore_index: Optional[int] = None) -> torch.Tensor:
    """Plain version: the [3, C, 256] histograms (count, fg sum, error sum)
    of this block of logits [b, h, w, C] and targets [b, h, w]."""
    _, _, fg, errors, _ = _planes(logits, targets, ignore_index)
    return torch.stack(lovasz_histograms_plain(errors, fg))


def lovasz_logits_grad_plain(logits: torch.Tensor, targets: torch.Tensor, hist: torch.Tensor,
                             ignore_index: Optional[int] = None):
    """Plain version: (value, logits gradient [b, h, w, C]) from the global
    histograms ``hist`` [3, C, 256] and this block's logits and targets."""
    probs, pr, fg, errors, valid = _planes(logits, targets, ignore_index)
    coef, value = coefficients(hist[0], hist[1], hist[2])
    w = lovasz_lookup_plain(errors, coef.contiguous())
    return value, _closed_form(w, pr, fg, valid, probs)


# copies the fused wrappers made of logits or targets whose layout the
# kernels do not take (every training path gives them one they take)
layout_copies: Dict[str, int] = {"logits": 0, "targets": 0}


def _check_region(logits: torch.Tensor, targets: torch.Tensor) -> None:
    if logits.ndim != 4:
        raise ValueError(f"logits must be [B, H, W, C], got {tuple(logits.shape)}")
    if tuple(targets.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"targets {tuple(targets.shape)} must be the logits' "
                         f"{tuple(logits.shape[:-1])}")


def _card_layout(logits: torch.Tensor, targets: torch.Tensor):
    """(logits contiguous [P, C] rows, int64 targets with H and W dense,
    pixels per image, the targets' batch stride) for the fused kernels,
    copying only what the kernels cannot read in place."""
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be torch.float32 or torch.bfloat16, got {logits.dtype}")
    b, h, w, c = logits.shape
    if c < 1:
        raise ValueError("the fused Lovász kernels take at least one class, got 0")
    if not logits.is_contiguous():
        logits = logits.contiguous()
        layout_copies["logits"] += 1
    dense = (w == 1 or targets.stride(2) == 1) and (h == 1 or targets.stride(1) == w)
    if targets.dtype != torch.int64 or not dense:
        targets = targets.to(torch.int64).contiguous()
        layout_copies["targets"] += 1
    bstride = targets.stride(0) if b > 1 else h * w
    return logits, targets, h * w, bstride


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def lovasz_logits_plan(c: int, p: int, sms: int) -> int:
    """Histogram blocks for C classes of P pixels on a card with ``sms`` SMs,
    by the kernel's own rule (``tpuseg_lovasz_logits_plan``): up to 32
    classes two resident on each SM, each under 2**23 pixels (its float
    counts exact); above, the pixel blocks of each class group, the groups'
    blocks filling the SMs once."""
    nblk = ctypes.c_int()
    rc = _c_fn("lovasz_logits_plan")(c, p, sms, ctypes.byref(nblk))
    if rc != 0:
        raise RuntimeError(f"lovasz logits plan failed: CUDA error {rc}")
    return nblk.value


def _scratch(c: int, p: int, nblk: int, grad: bool, device: torch.device) -> torch.Tensor:
    """The scratch bytes a fused kernel takes (``tpuseg_lovasz_logits_scratch``):
    the histograms' block partials, or above 32 classes their pixel stats
    and integer totals; the gradient's coefficient table above 32 classes."""
    n = ctypes.c_longlong()
    rc = _c_fn("lovasz_logits_scratch")(c, p, nblk, int(grad), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"lovasz logits scratch failed: CUDA error {rc}")
    return torch.empty(n.value, dtype=torch.uint8, device=device)


def _ignore_args(ignore_index: Optional[int]):
    return (0, 0) if ignore_index is None else (1, int(ignore_index))


def lovasz_logits_histograms(logits: torch.Tensor, targets: torch.Tensor,
                             ignore_index: Optional[int] = None) -> torch.Tensor:
    """The [3, C, 256] histograms (count, fg sum, error sum) of this block
    of logits [b, h, w, C] and targets [b, h, w], straight from the logits.
    On a CUDA tensor the fused kernels read the logits (f32 or bf16, any
    number of classes); the counts and fg sums are the exact totals rounded
    once to f32, the error sums integer sums of each error's offset in its
    bin (in units of 2**-40), so every call repeats bit for bit."""
    _check_region(logits, targets)
    if not _on_cuda(logits, targets):
        return lovasz_logits_histograms_plain(logits, targets, ignore_index)
    lg, tg, hw, bstride = _card_layout(logits, targets)
    c = lg.shape[-1]
    p = lg.numel() // c
    nblk = lovasz_logits_plan(c, p, _sms(lg.device))
    scratch = _scratch(c, p, nblk, False, lg.device)
    hist = torch.empty((3, c, NB), dtype=torch.float32, device=lg.device)
    _launch("lovasz_logits_histograms", lg.device, lg.data_ptr(), tg.data_ptr(),
            scratch.data_ptr(), hist.data_ptr(), c, p, hw, bstride,
            *_ignore_args(ignore_index), nblk, int(lg.dtype == torch.bfloat16))
    launches["lovasz_logits_histograms"] += 1
    return hist


def lovasz_logits_grad(logits: torch.Tensor, targets: torch.Tensor, hist: torch.Tensor,
                       ignore_index: Optional[int] = None):
    """(value, f32 logits gradient [b, h, w, C]) from the global histograms
    ``hist`` [3, C, 256] and this block's logits and targets. On a CUDA
    tensor the coefficients and the value come from ``hist`` (up to 32
    classes in every block of the fused kernel, above in a kernel of their
    own), then each pixel's softmax is recomputed and its gradient
    written."""
    _check_region(logits, targets)
    c = logits.shape[-1]
    if tuple(hist.shape) != (3, c, NB):
        raise ValueError(f"hist must be [3, {c}, {NB}], got {tuple(hist.shape)}")
    if not _on_cuda(logits, targets, hist):
        return lovasz_logits_grad_plain(logits, targets, hist, ignore_index)
    _require_contiguous(hist=hist)
    lg, tg, hw, bstride = _card_layout(logits, targets)
    p = lg.numel() // c
    nblk = max(1, min(2 * _sms(lg.device), -(-p // (_THREADS * 4))))
    scratch = _scratch(c, p, nblk, True, lg.device)
    value = torch.empty((), dtype=torch.float32, device=lg.device)
    grad = torch.empty(lg.shape, dtype=torch.float32, device=lg.device)
    _launch("lovasz_logits_grad", lg.device, lg.data_ptr(), tg.data_ptr(), hist.data_ptr(),
            scratch.data_ptr(), value.data_ptr(), grad.data_ptr(), c, p, hw, bstride,
            *_ignore_args(ignore_index), nblk, int(lg.dtype == torch.bfloat16))
    launches["lovasz_logits_grad"] += 1
    return value, grad


def lovasz_logits_parts(logits: torch.Tensor, targets: torch.Tensor, mesh, spatial: bool,
                        ignore_index: Optional[int], histograms=lovasz_logits_histograms,
                        grad=lovasz_logits_grad):
    """(value, hist, grad) of the Lovász over the mesh's global batch (this
    block's alone with no mesh): the local histograms, ONE all_reduce of
    them over the data axis (the whole mesh with ``spatial``), then the
    value and this block's logits gradient from the global histograms."""
    hist = histograms(logits, targets, ignore_index)
    all_reduce_(hist, mesh, None if mesh is None else mesh.axis_group(spatial))
    value, g = grad(logits, targets, hist, ignore_index)
    return value, hist, g


class _LovaszLogits(torch.autograd.Function):
    """The value of the global batch's Lovász (alike on every rank); in
    backward, g times this rank's closed-form logits gradient. Nothing is
    all-reduced in backward: the parameter gradients are summed in the
    train step."""

    @staticmethod
    def forward(ctx, logits, targets, mesh, spatial, ignore_index, histograms, grad):
        value, _, g = lovasz_logits_parts(logits, targets, mesh, spatial, ignore_index,
                                          histograms, grad)
        ctx.save_for_backward(g)
        ctx.logits_dtype = logits.dtype
        return value

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return (g * grad).to(ctx.logits_dtype), None, None, None, None, None, None


def lovasz_logits_loss(logits: torch.Tensor, targets: torch.Tensor,
                       ignore_index: Optional[int] = None) -> torch.Tensor:
    """The binned Lovász-softmax of one card's logits [B, H, W, C] and
    targets: a scalar whose backward gives the logits their closed-form
    gradient (the fused kernels on a CUDA tensor, no all_reduce)."""
    return _LovaszLogits.apply(logits, targets, None, False, ignore_index,
                               lovasz_logits_histograms, lovasz_logits_grad)


def lovasz_logits_loss_plain(logits: torch.Tensor, targets: torch.Tensor,
                             ignore_index: Optional[int] = None) -> torch.Tensor:
    """The same op built on the plain versions, on any device."""
    return _LovaszLogits.apply(logits, targets, None, False, ignore_index,
                               lovasz_logits_histograms_plain, lovasz_logits_grad_plain)


def make_sharded_lovasz(mesh, spatial: bool = False,
                        ignore_index: Optional[int] = None) -> Callable:
    """The multi-rank Lovász at the logits level, the port of
    ``lovasz_pallas.make_sharded_lovasz``: ``(logits, targets) -> scalar``
    on this rank's block of the global batch (rows on "data", and H on
    "spatial" with ``spatial``), whose value is the global batch's and whose
    backward gives this rank's logits their gradient of it. On a CUDA
    tensor the two fused kernels run around the one all_reduce; on a CPU
    tensor their plain versions."""
    def fn(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return _LovaszLogits.apply(logits, targets, mesh, bool(spatial), ignore_index,
                                   lovasz_logits_histograms, lovasz_logits_grad)

    return fn
