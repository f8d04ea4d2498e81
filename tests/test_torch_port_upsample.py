"""The cascaded x2 upsample's host side, on the CPU (``ops/upsample.py``).

The kernel pair runs only on the card (tests/test_torch_port_cuda.py).
Here: a CPU tensor takes the plain path and launches nothing; the limits
the kernels are compiled with are the wrapper's; the tables
the kernels read are the plain version's taps and, transposed, its
``_bilinear_matrix``; the gather the backward kernel computes from them,
written out in torch, is autograd of the plain path bit for bit (the CPU's
``index_add`` adds in index order, the order the gather takes); and the
bands of both plans fit shared memory and cover every input they need.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuseg_torch.ops import kernels
from tpuseg_torch.ops import upsample as up
from tpuseg_torch.ops.resize import (_bilinear_matrix, _tap_tensors, resize_bilinear,
                                     up_pow2_bilinear, upsample2x_bilinear)

CASES = [(t, ac) for t in (1, 2, 3) for ac in (False, True)]
# the cells' shapes (DeepLab's x4 logits and x8 ASPP, the UNet head at
# train and serve sizes, a decoder edge of the subpixel rewrite) and ragged
PLAN_SHAPES = [(32, 64, 128, 66, 2), (32, 8, 16, 256, 3), (64, 64, 128, 10, 1),
               (16, 256, 512, 10, 1), (64, 2, 8, 1280, 1), (2, 5, 7, 3, 2), (1, 1, 1, 1, 3),
               (3, 9, 1, 66, 3), (1, 33, 65, 1, 2)]


def _x(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(dtype)


def _cascade(x: torch.Tensor, times: int, ac: bool) -> torch.Tensor:
    """The plain version: ``times`` x2 ``resize_bilinear`` steps."""
    for _ in range(times):
        x = resize_bilinear(x, 2 * x.shape[-3], 2 * x.shape[-2], ac)
    return x


@pytest.mark.parametrize("times,ac", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_path_and_launch_nothing(times, ac, dtype):
    x = _x((2, 5, 3, 4), times, dtype)
    before = dict(kernels.launches)
    want = _cascade(x, times, ac)
    got = x
    for _ in range(times):
        got = upsample2x_bilinear(got, align_corners=ac)
    assert got.dtype == dtype and got.shape == (2, 5 << times, 3 << times, 4)
    assert torch.equal(got, want)
    if not ac:
        assert torch.equal(up_pow2_bilinear(x, times), want)
    assert kernels.launches == before
    # the kernel pair itself takes CUDA tensors alone
    with pytest.raises(ValueError, match="CUDA tensor"):
        up.upsample_pow2(x, times, ac)
    assert kernels.launches == before


def test_the_kernels_limits_are_the_wrappers():
    """The constants compiled into csrc/upsample_pow2.cu are ops/upsample.py's
    (read from the source here; the library reports its own on the card)."""
    src = (Path(up.__file__).parents[1] / "csrc" / "upsample_pow2.cu").read_text()

    def const(name):
        (expr,) = re.findall(rf"constexpr int {name} = ([0-9 *]+);", src)
        return int(np.prod([int(t) for t in expr.split("*")]))

    assert (const("MAX_LEVELS"), const("MAX_FOOT"), const("STAGES"), const("SMEM_MAX")) == \
        (up.MAX_TIMES, up.MAX_FOOT, up.STAGES, up.SMEM_MAX)


@pytest.mark.parametrize("offset", [0, 1])
def test_a_library_built_with_other_limits_is_refused(monkeypatch, offset):
    def fake(name):
        assert name == "upsample_pow2_limits"

        def limits(out):
            ctypes.memmove(out, (ctypes.c_int * 4)(up.MAX_TIMES, up.MAX_FOOT,
                                                   up.STAGES + offset, up.SMEM_MAX), 16)
            return 0
        return limits

    monkeypatch.setattr(up, "_c_fn", fake)
    up._library_limits.cache_clear()
    try:
        if offset:
            with pytest.raises(RuntimeError, match="rebuild"):
                up._library_limits()
        else:
            assert up._library_limits() == (up.MAX_TIMES, up.MAX_FOOT, up.STAGES, up.SMEM_MAX)
    finally:
        up._library_limits.cache_clear()


@pytest.mark.parametrize("times,ac", CASES)
def test_tables_hold_the_plain_taps_and_the_transposed_matrix(times, ac):
    h, w = 3, 5
    tabs = up.tables(h, w, times, ac)
    assert len(tabs) == 4 * times
    for s in range(times):
        for n, taps, fp in ((h << s, tabs[4 * s], tabs[4 * s + 2]),
                            (w << s, tabs[4 * s + 1], tabs[4 * s + 3])):
            lo, hi, w_lo, w_hi = _tap_tensors(n, 2 * n, ac, torch.device("cpu"), torch.float32)
            assert np.array_equal(taps[:, 0], lo.numpy()) and np.array_equal(taps[:, 1], hi.numpy())
            assert np.array_equal(taps[:, 2].view(np.float32), w_lo.numpy())
            assert np.array_equal(taps[:, 3].view(np.float32), w_hi.numpy())
            # the gather's matrix: input k takes output i's 1 - frac where
            # lo(i) = k and its frac where hi(i) = k
            dense = np.zeros((n, 2 * n))
            for k in range(n):
                dense[k, fp[k, 0]:fp[k, 1]] += taps[fp[k, 0]:fp[k, 1], 2].view(np.float32)
                dense[k, fp[k, 2]:fp[k, 3]] += taps[fp[k, 2]:fp[k, 3], 3].view(np.float32)
            # _bilinear_matrix sums 1 - frac in float64 before rounding once
            np.testing.assert_allclose(dense, _bilinear_matrix(n, 2 * n, ac).T, rtol=0,
                                       atol=6e-8)
            assert fp[:, [1, 3]].max() <= 2 * n and (np.diff(fp, axis=0) >= 0).all()
    tensor = up._table_tensor(h, w, times, ac, torch.device("cpu"))
    assert tensor.dtype == torch.int32 and tensor.shape == (sum(len(t) for t in tabs), 4)


def _gather_grad(g: torch.Tensor, times: int, ac: bool) -> torch.Tensor:
    """The backward kernel's arithmetic in torch: per step from the last,
    T = W^T G then G = H^T T, each transposed sum from +0 over the outputs
    in its footprint in ascending order, lo sum plus hi sum, G rounded to
    g's dtype at every step boundary."""
    dtype = g.dtype
    h, w = g.shape[1] >> times, g.shape[2] >> times
    tabs = up.tables(h, w, times, ac)
    grad = g.to(torch.float32)
    for s in range(times, 0, -1):
        for axis, taps, fp in ((2, tabs[4 * (s - 1) + 1], tabs[4 * (s - 1) + 3]),
                               (1, tabs[4 * (s - 1)], tabs[4 * (s - 1) + 2])):
            w_lo = torch.from_numpy(taps[:, 2].view(np.float32).copy())
            w_hi = torch.from_numpy(taps[:, 3].view(np.float32).copy())
            src = grad.movedim(axis, 0)
            out = []
            for k in range(len(fp)):
                lo = torch.zeros_like(src[0])
                for i in range(fp[k, 0], fp[k, 1]):
                    lo = lo + src[i] * w_lo[i]
                hi = torch.zeros_like(src[0])
                for i in range(fp[k, 2], fp[k, 3]):
                    hi = hi + src[i] * w_hi[i]
                out.append(lo + hi)
            grad = torch.stack(out).movedim(0, axis)
        grad = grad.to(dtype).to(torch.float32)
    return grad.to(dtype)


@pytest.mark.parametrize("times,ac", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_gather_is_autograd_of_the_plain_path_bit_for_bit(times, ac, dtype):
    x = _x((2, 3, 4, 5), 10 + times, dtype).requires_grad_(True)
    y = _cascade(x, times, ac)
    g = _x(tuple(y.shape), 20 + times, dtype)
    (want,) = torch.autograd.grad(y, x, g)
    got = _gather_grad(g, times, ac)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("ac", [False, True])
def test_forward_bands_fit_and_reach_every_input_they_read(shape, ac):
    b, h, w, c, times = shape
    p = up.forward_plan(b, h, w, c, times, ac)
    tabs = up.tables(h, w, times, ac)
    wl, hl = w << times, h << times
    assert p.smem == sum(2 * n * p.cg * 4 for n in p.nw) <= up.SMEM_MAX
    assert p.smem <= up.SMEM_BUDGET or p.tw == 1
    assert c % p.cg == 0 and (p.cg == c or (p.cg % 4 == 0 and p.cg * 4 >= 128))
    assert p.ctas == b * (c // p.cg) * -(-wl // p.tw) * -(-hl // p.th)
    # brute force: the columns each band's outputs read, level by level
    for c0 in range(0, wl, p.tw):
        cols = np.arange(c0, min(c0 + p.tw, wl))
        for s in range(times, 0, -1):
            taps = tabs[4 * (s - 1) + 1]
            cols = np.unique(taps[cols, :2])
            assert cols.max() - cols.min() + 1 <= p.nw[s - 1]
            assert np.array_equal(cols, np.arange(cols.min(), cols.max() + 1))


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("ac", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_backward_bands_fit_and_hold_every_output_they_gather(shape, ac, itemsize):
    b, h, w, c, times = shape
    p = up.backward_plan(b, h, w, c, times, ac, itemsize)
    tabs = up.tables(h, w, times, ac)
    assert p.smem <= up.SMEM_MAX and (p.smem <= up.SMEM_BUDGET or p.tw == 1)
    vec = 16 // itemsize
    assert c % p.cg == 0 and (p.cg == c or (p.cg % vec == 0 and p.cg * itemsize >= 128))
    assert p.ctas == b * (c // p.cg) * -(-w // p.tw) * -(-h // p.th)
    for s in range(times):
        fp = tabs[4 * s + 2]
        # a level-s row's gradient gathers the rows of level s + 1 from hi_begin
        # to lo_end: all of them sit in the ring at once
        assert p.slots[s] == int((fp[:, 1] - fp[:, 2]).max())
        assert (fp[:, 1] - fp[:, 2] <= p.slots[s]).all()
    for c0 in range(0, w, p.tw):
        cols = np.arange(c0, min(c0 + p.tw, w))
        for s in range(1, times + 1):
            fp = tabs[4 * (s - 1) + 3]
            outs = np.concatenate([np.arange(f[0], f[1]) for f in fp[cols]]
                                  + [np.arange(f[2], f[3]) for f in fp[cols]])
            span = (fp[cols[0], 2], fp[cols[-1], 1])
            assert outs.min() >= span[0] and outs.max() < span[1]
            assert span[1] - span[0] <= p.nw[s - 1]
            cols = np.arange(*span)


def test_the_card_refuses_other_dtypes_before_any_launch():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        up._check_card(torch.zeros(1, 2, 2, 1, dtype=torch.float16), 1)
    with pytest.raises(ValueError, match="1..3"):
        up._check_card(torch.zeros(1, 2, 2, 1), 4)
