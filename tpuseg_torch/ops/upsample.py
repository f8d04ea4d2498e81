"""The cascaded x2 bilinear upsample as one CUDA kernel pair, with autograd.

``upsample_pow2(x, times, align_corners)`` is ``times`` (1 to 3) exact x2
bilinear steps of an NHWC CUDA tensor, each step H then W and rounded to
``x.dtype``, as ``ops/resize.py`` defines them: the FPN and DeepLab
families' ``up_pow2_bilinear`` and the x2 of ``upsample2x_bilinear``
(decoder and head). It launches ``csrc/upsample_pow2.cu``
(``tpuseg_upsample_pow2``, and in backward ``tpuseg_upsample_pow2_grad``).
``ops/resize.py`` calls it for CUDA tensors outside the spatial mode and
with no ``compute_dtype``, and keeps everything else, CPU tensors included,
on its own plain path.

It replaces no TPU kernel (the JAX package upsamples with plain XLA). The
plain version materialises each pass and scatters its gradient with
``index_add``; the kernels read and write each byte once (the source says
how). The forward is bit-equal to the plain version; the backward gathers
each input index's outputs in a fixed order, so it repeats bit for bit and
differs from autograd of the plain version only in the order of its 1-4
term sums.

The host side: the taps and footprint tables (``tables``, made once per
shape and device), and what each CTA owns (``forward_plan``,
``backward_plan``, each made once per shape): the widest column band whose
shared memory fits ``SMEM_BUDGET``, with every channel or, where C is wide,
a group of them (whole 128-byte lines a pixel), and row bands enough for
``TARGET_CTAS`` CTAs. The limits the kernels were compiled with
(``MAX_TIMES``, ``MAX_FOOT``, ``STAGES``, ``SMEM_MAX``) are read from the
library once and must equal this module's. fp32 and bf16 only; any other
dtype raises ``TypeError``. Launches are counted in
``launches["upsample_pow2"]`` and ``["upsample_pow2_grad"]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpuseg_torch.ops.kernels import ACTIVATION_DTYPES, _c_fn, _launch, launches
from tpuseg_torch.ops.resize import _bilinear_taps, _taps64

# compiled into the kernels too (csrc/upsample_pow2.cu); _library_limits
# holds the two copies equal
MAX_TIMES = 3
MAX_FOOT = 4                  # the kernels' bound on the outputs a tap index gathers
STAGES = 3                    # backward: gradient rows the kernel stages at once
SMEM_MAX = 227 * 1024         # a CTA's limit on the H100
# the plans' own rule
SMEM_BUDGET = 75 * 1024       # shared memory a CTA may take while it can: 3 CTAs an SM
TARGET_CTAS = 1024


def step_taps(n: int, align_corners: bool) -> np.ndarray:
    """int32 [2n, 4]: {lo, hi, float32 bits of 1 - frac, of frac} of each
    output of one x2 step over n inputs: ``resize_bilinear``'s own taps."""
    lo, hi, frac = _bilinear_taps(n, 2 * n, align_corners)
    return np.stack([lo, hi, (np.float32(1.0) - frac).view(np.int32), frac.view(np.int32)],
                    axis=1).astype(np.int32)


def step_footprints(n: int, align_corners: bool) -> np.ndarray:
    """int32 [n, 4]: {lo_begin, lo_end, hi_begin, hi_end} of each input of
    one x2 step over n inputs: the outputs whose lo tap, and whose hi tap,
    is that input (both sorted, so each is a range)."""
    lo, hi, _ = _taps64(n, 2 * n, align_corners)
    k = np.arange(n)
    return np.stack([np.searchsorted(lo, k, "left"), np.searchsorted(lo, k, "right"),
                     np.searchsorted(hi, k, "left"), np.searchsorted(hi, k, "right")],
                    axis=1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def tables(h: int, w: int, times: int, align_corners: bool) -> Tuple[np.ndarray, ...]:
    """Per step s = 1..times: (row taps, column taps, row footprints,
    column footprints) of the x2 step from h << (s-1) by w << (s-1)."""
    out = []
    for s in range(times):
        hs, ws = h << s, w << s
        parts = (step_taps(hs, align_corners), step_taps(ws, align_corners),
                 step_footprints(hs, align_corners), step_footprints(ws, align_corners))
        for taps in parts[:2]:
            # the forward keeps two rows a level: lo climbs by at most one
            # and hi is lo or lo + 1
            if np.any(np.diff(taps[:, 0]) > 1) or np.any(taps[:, 1] - taps[:, 0] > 1):
                raise AssertionError("an x2 step's taps left the two-row ring's reach")
        for fp in parts[2:]:
            if np.any(fp[:, 1] - fp[:, 0] > MAX_FOOT) or np.any(fp[:, 3] - fp[:, 2] > MAX_FOOT):
                raise AssertionError(f"a footprint past the kernel's {MAX_FOOT} terms")
        out.extend(parts)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _table_tensor(h: int, w: int, times: int, align_corners: bool,
                  device: torch.device) -> torch.Tensor:
    """``tables`` as one int32 [N, 4] tensor on ``device``, made once per
    shape (a captured step cannot copy from pageable memory); a normal
    tensor even under ``inference_mode``, as ``resize._tap_tensors``."""
    flat = np.ascontiguousarray(np.concatenate(tables(h, w, times, align_corners)))
    with torch.inference_mode(False):
        return torch.from_numpy(flat).to(device)


class Plan(NamedTuple):
    cg: int               # channels a CTA owns: all of them, or a group
    tw: int               # columns a CTA owns (output columns forward, input backward)
    th: int               # rows a CTA owns (likewise)
    nw: Tuple[int, ...]   # the most columns a band spans at each level the kernel keeps
    slots: Tuple[int, ...]  # backward: ring slots per step (the widest row footprint)
    smem: int             # bytes of shared memory per CTA
    ctas: int


def _candidates(n: int):
    """n, then the powers of two below it, descending."""
    yield n
    p = 1
    while 2 * p < n:
        p *= 2
    while 1 <= p < n:
        yield p
        p //= 2


def _groups(c: int, itemsize: int):
    """The channels a CTA may own: all c, then halves while a group stays a
    multiple of 16 bytes and at least 128 bytes (whole cache lines)."""
    vec = 16 // itemsize
    cg = c
    yield cg
    while c % vec == 0 and cg % (2 * vec) == 0 and cg // 2 * itemsize >= 128:
        cg //= 2
        yield cg


def _widest(width: int, c: int, itemsize: int, columns, smem):
    """(cg, tw, nw, bytes): the widest column band tw whose shared memory
    ``smem(nw, cg)`` fits SMEM_BUDGET for some channel group (the most
    channels among those as wide), ``columns(tw)`` giving nw; else the
    least memory, one column and the smallest group."""
    best = None
    for cg in _groups(c, itemsize):
        for tw in _candidates(width):
            nw = columns(tw)
            if smem(nw, cg) <= SMEM_BUDGET:
                if best is None or tw > best[1]:
                    best = (cg, tw, nw, smem(nw, cg))
                break
    if best is None:
        nw = columns(1)
        best = (cg, 1, nw, smem(nw, cg))
    if best[3] > SMEM_MAX:
        raise ValueError(f"upsample_pow2: {c} channels need {best[3]} bytes of shared memory")
    return best


def _row_band(ctas: int, rows: int) -> int:
    """Rows a CTA owns: halved from all of them until the grid holds
    TARGET_CTAS CTAs (or one row), ``ctas`` CTAs a row band."""
    th = rows
    while th > 1 and ctas * -(-rows // th) < TARGET_CTAS:
        th = -(-th // 2)
    return th


@functools.lru_cache(maxsize=None)
def forward_plan(b: int, h: int, w: int, c: int, times: int, align_corners: bool,
                 itemsize: int = 4) -> Plan:
    """The forward's bands: cg channels, output columns tw and rows th a
    CTA; nw[s], the most columns of level s (0..times-1) any band reads."""
    steps = tables(h, w, times, align_corners)
    wl = w << times

    def columns(tw):
        a = np.arange(0, wl, tw)
        z = np.minimum(a + tw, wl) - 1
        nw = []
        for s in range(times, 0, -1):
            cols = steps[4 * (s - 1) + 1]
            a, z = cols[a, 0], cols[z, 1]
            nw.insert(0, int((z - a).max()) + 1)
        return nw

    cg, tw, nw, smem = _widest(wl, c, itemsize, columns,
                               lambda nw, cg: sum(2 * n * cg * 4 for n in nw))
    ctas = b * (c // cg) * -(-wl // tw)
    th = _row_band(ctas, h << times)
    return Plan(cg, tw, th, tuple(nw), (), smem, ctas * -(-(h << times) // th))


@functools.lru_cache(maxsize=None)
def backward_plan(b: int, h: int, w: int, c: int, times: int, align_corners: bool,
                  itemsize: int) -> Plan:
    """The backward's bands: cg channels, input columns tw and rows th a
    CTA; nw[s], the most columns of level s (1..times) a band's gradient
    spans; slots[s], the widest row footprint of step s (the rows its ring
    holds)."""
    steps = tables(h, w, times, align_corners)
    slots = [int((steps[4 * s + 2][:, 1] - steps[4 * s + 2][:, 2]).max()) for s in range(times)]
    vec = 16 // itemsize

    def columns(tw):
        a = np.arange(0, w, tw)
        z = np.minimum(a + tw, w) - 1
        nw = [tw]
        for s in range(1, times + 1):
            fp = steps[4 * (s - 1) + 3]
            a, z = fp[a, 2], fp[z, 1] - 1
            nw.append(int((z - a).max()) + 1)
        return nw

    def smem(nw, cg):
        stage = -(-(nw[times] * cg + 2 * vec) // vec) * vec
        return (STAGES * stage * itemsize + sum(nw[s] * cg * 4 for s in range(1, times))
                + sum(slots[s - 1] * nw[s - 1] * cg * 4 for s in range(1, times + 1)))

    cg, tw, nw, nbytes = _widest(w, c, itemsize, columns, smem)
    ctas = b * (c // cg) * -(-w // tw)
    th = _row_band(ctas, h)
    return Plan(cg, tw, th, tuple(nw[1:]), tuple(slots), nbytes, ctas * -(-h // th))


def _as_batch(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> contiguous [B, H, W, C]."""
    if x.ndim < 3:
        raise ValueError(f"upsample_pow2 takes [..., H, W, C], got {tuple(x.shape)}")
    return x.contiguous().reshape(-1, *x.shape[-3:])


@functools.lru_cache(maxsize=None)
def _library_limits() -> Tuple[int, ...]:
    """(MAX_TIMES, MAX_FOOT, STAGES, SMEM_MAX) as the library was compiled;
    raises where they are not this module's."""
    got = (ctypes.c_int * 4)()
    _c_fn("upsample_pow2_limits")(got)
    want = (MAX_TIMES, MAX_FOOT, STAGES, SMEM_MAX)
    if tuple(got) != want:
        raise RuntimeError(f"upsample_pow2: the library's limits {tuple(got)} are not "
                           f"ops/upsample.py's {want}: rebuild it")
    return want


def _check_card(x: torch.Tensor, times: int) -> None:
    if x.dtype not in ACTIVATION_DTYPES:
        raise TypeError(f"upsample_pow2 takes float32 or bfloat16 on the card, got {x.dtype}")
    if not 1 <= times <= MAX_TIMES:
        raise ValueError(f"upsample_pow2 takes 1..{MAX_TIMES} x2 steps, got {times}")
    if not x.is_cuda:
        raise ValueError(f"upsample_pow2 takes a CUDA tensor, got one on {x.device} "
                         "(ops/resize.py keeps the others on its plain path)")


def _forward(x: torch.Tensor, times: int, align_corners: bool) -> torch.Tensor:
    xb = _as_batch(x)
    b, h, w, c = xb.shape
    out = torch.empty((b, h << times, w << times, c), dtype=x.dtype, device=x.device)
    if out.numel():
        p = forward_plan(b, h, w, c, times, align_corners, x.element_size())
        tab = _table_tensor(h, w, times, align_corners, x.device)
        nw = (*p.nw, 0, 0)[:3]
        _launch("upsample_pow2", x.device, xb.data_ptr(), out.data_ptr(), tab.data_ptr(),
                b, h, w, c, p.cg, times, p.tw, p.th, *nw, int(x.dtype == torch.bfloat16))
        launches["upsample_pow2"] += 1
    return out.reshape(*x.shape[:-3], h << times, w << times, c)


def _backward(g: torch.Tensor, shape: torch.Size, times: int,
              align_corners: bool) -> torch.Tensor:
    gb = _as_batch(g)
    if gb.data_ptr() % 16:
        gb = gb.clone()
    h, w, c = shape[-3:]
    b = gb.shape[0]
    dx = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    if dx.numel():
        p = backward_plan(b, h, w, c, times, align_corners, g.element_size())
        tab = _table_tensor(h, w, times, align_corners, g.device)
        nw, slots = (*p.nw, 0, 0)[:3], (*p.slots, 0, 0)[:3]
        _launch("upsample_pow2_grad", g.device, gb.data_ptr(), dx.data_ptr(), tab.data_ptr(),
                b, h, w, c, p.cg, times, p.tw, p.th, *nw, *slots,
                int(g.dtype == torch.bfloat16))
        launches["upsample_pow2_grad"] += 1
    return dx.reshape(shape)


class _UpsamplePow2(torch.autograd.Function):
    """The kernel pair: the gradient of x from the gradient of the output."""

    @staticmethod
    def forward(ctx, x, times, align_corners):
        ctx.geometry = (x.shape, times, align_corners)
        return _forward(x, times, align_corners)

    @staticmethod
    def backward(ctx, g):
        shape, times, align_corners = ctx.geometry
        return _backward(g, shape, times, align_corners), None, None


def upsample_pow2(x: torch.Tensor, times: int, align_corners: bool = False) -> torch.Tensor:
    """``times`` exact x2 bilinear steps of a CUDA [..., H, W, C] (float32
    or bfloat16), each rounded to ``x.dtype``: the kernel pair."""
    _check_card(x, times)
    _library_limits()
    return _UpsamplePow2.apply(x, times, align_corners)
