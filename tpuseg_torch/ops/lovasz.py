"""The sort-free Lovász-softmax loss's two CUDA kernels, their plain
versions, and the autograd op built on them.

The port of ``tpuseg/ops/lovasz_pallas.py``:

==================  ===========================  ========================
wrapper             CUDA source (tpuseg_torch/)  plain PyTorch version
==================  ===========================  ========================
lovasz_histograms   csrc/lovasz_histograms.cu    lovasz_histograms_plain
lovasz_lookup       csrc/lovasz_lookup.cu        lovasz_lookup_plain
==================  ===========================  ========================

``lovasz_binned_kernel(errors, fg)`` is ``lovasz_binned_pallas``: the
histograms give per-bin Lovász coefficients (``coefficients``, plain
tensor ops on [C, 256]) and the loss value; the lookup gives each pixel's
coefficient w, which is the gradient d loss / d errors.

The binning is the TPU kernel's, on both routes: a pixel's bin is
``clip(trunc(e * 256), 0, 255)``, so e = 1.0 falls in bin 255, and a
pixel with e < 0 enters no bin. (The JAX package's XLA scan,
``tpuseg/train/loss.py::_binned_lovasz``, gives e = 1.0 a level of its
own; the two agree wherever no error is exactly 1.0.)

``make_sharded_lovasz(mesh)`` is the multi-rank form, the port of
``lovasz_pallas.make_sharded_lovasz``: each rank bins its block of the
global batch with the same two kernels, one all_reduce of the [3, C, 256]
histograms makes them global, and the logits gradient is computed in
closed form (``sharded_lovasz_parts``, which takes the two functions it
bins and looks up with: the kernels, or their plain versions for holding
the kernels' route against them).

Dispatch goes by the tensor's device, as in ``ops/kernels.py``: a CPU
tensor runs the plain version; a CUDA tensor launches the kernel or
raises. Each launch adds one to ``kernels.launches[<wrapper name>]``.

Both kernels are bound by the bytes of the [C, P] planes. The histogram
kernel loads e and fg as float4s, several per thread in flight, and adds
into 32 lane-private copies of the histograms in shared memory, so the
lanes of a warp never collide; its grid fills the card's resident slots
once (``lovasz_hist_plan``, the kernel's own rule, from the SM count).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

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
# the sharded op: local kernels, one all_reduce, the closed-form gradient


def sharded_lovasz_parts(logits: torch.Tensor, targets: torch.Tensor, mesh, spatial: bool,
                         ignore_index: Optional[int], histograms, lookup):
    """(value, coef, grad) of the Lovász over the mesh's global batch, from
    this rank's block of logits [b, h, w, C] and targets [b, h, w]: the
    region of ``lovasz_pallas.make_sharded_lovasz``, step by step.

    The local [C, P] planes give local histograms; ONE all_reduce of the
    three, stacked into one [3, C, 256] buffer, over the data axis (the
    whole mesh with ``spatial``) makes them the global batch's; the
    coefficients and the value follow on every rank alike; the local
    lookup gives w, and the logits gradient is the closed-form softmax
    chain dL/dz_k = wt_k p_k - p_k sum_c wt_c p_c with
    wt = w sign(p - fg) valid, the product autodiff would build from
    sum |fg - p| * w with w held constant."""
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
    errors, fg = errors.contiguous(), fg.contiguous()
    hist = torch.stack(histograms(errors, fg))                # [3, C, 256]
    all_reduce_(hist, mesh, None if mesh is None else mesh.axis_group(spatial))
    coef, value = coefficients(hist[0], hist[1], hist[2])
    w = lookup(errors, coef.contiguous())                     # [C, P]
    wt = w * torch.sign(pr - fg)
    if valid is not None:
        wt = wt * valid
    wp = wt.t().reshape(probs.shape) * probs
    grad = wp - probs * wp.sum(dim=-1, keepdim=True)
    return value, coef, grad


class _ShardedLovasz(torch.autograd.Function):
    """The value of the global batch's Lovász (alike on every rank); in
    backward, g times this rank's closed-form logits gradient. Nothing is
    all-reduced in backward: the parameter gradients are summed in the
    train step."""

    @staticmethod
    def forward(ctx, logits, targets, mesh, spatial, ignore_index, histograms, lookup):
        value, _, grad = sharded_lovasz_parts(logits, targets, mesh, spatial, ignore_index,
                                              histograms, lookup)
        ctx.save_for_backward(grad)
        ctx.logits_dtype = logits.dtype
        return value

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return (g * grad).to(ctx.logits_dtype), None, None, None, None, None, None


def make_sharded_lovasz(mesh, spatial: bool = False,
                        ignore_index: Optional[int] = None) -> Callable:
    """The multi-rank Lovász at the logits level, the port of
    ``lovasz_pallas.make_sharded_lovasz``: ``(logits, targets) -> scalar``
    on this rank's block of the global batch (rows on "data", and H on
    "spatial" with ``spatial``), whose value is the global batch's and whose
    backward gives this rank's logits their gradient of it. On a CUDA
    tensor the two kernels run on the local planes; on a CPU tensor their
    plain versions."""
    def fn(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return _ShardedLovasz.apply(logits, targets, mesh, bool(spatial), ignore_index,
                                    lovasz_histograms, lovasz_lookup)

    return fn
