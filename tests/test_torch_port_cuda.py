"""Card-only tests of the port's CUDA kernels against their plain versions.

Each kernel runs at the serving and training paths' shapes and at ragged
ones, on the card, beside its plain PyTorch version on the same inputs. Without a CUDA
card every test here skips (the decision is taken inside the ``card``
fixture, so every worker collects the same tests). On the machine with the
card, whose Python has no JAX (which ``tests/conftest.py`` imports):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from tpuseg_torch.data.class_maps import COLOR_MAP_BGR, COLOR_MAP_RGB
from tpuseg_torch.models.mobilenetv2 import MobileNetV2Encoder, inverted_residual_shapes
from tpuseg_torch.ops import kernels
from tpuseg_torch.ops.resize import upsample2x_bilinear

pytestmark = pytest.mark.cuda

NEAR_TIE = 1e-5   # logit margin under which two argmax picks may differ
# fp32 conv sums of up to 12,096 terms taken in another order than cuDNN's
RTOL = ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _randn(shape, seed, scale=1.0):
    return torch.from_numpy(
        (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    ).cuda()


@pytest.mark.parametrize("shape", [(8, 128, 256, 10), (1, 3, 5, 4), (2, 7, 33, 10)])
def test_argmax_colorize_matches_plain(card, shape):
    palette = COLOR_MAP_RGB if shape[-1] == 4 else COLOR_MAP_BGR
    logits = _randn(shape, 0)
    before = kernels.launches["argmax_colorize"]
    cls, col = kernels.argmax_colorize(logits, palette)
    cls_p, col_p = kernels.argmax_colorize_plain(logits, palette)
    assert kernels.launches["argmax_colorize"] == before + 1
    assert cls.dtype == torch.uint8 and col.dtype == torch.uint32
    assert torch.equal(cls, cls_p)
    assert np.array_equal(col.cpu().numpy(), col_p.cpu().numpy())


# the served head's shape, odd W (2W not a multiple of 4, rows off 4 bytes),
# one class, 19 classes, one pixel, and 256 classes over a wide row (the
# kernel splits the row into column segments)
UPSAMPLE_SHAPES = [(8, 64, 128, 10), (2, 5, 7, 3), (1, 1, 1, 10), (2, 6, 9, 19),
                   (3, 4, 5, 1), (1, 3, 70, 256)]


@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES)
def test_upsample2x_argmax_matches_plain(card, shape):
    logits = _randn(shape, 1)
    got = kernels.upsample2x_argmax(logits)
    want = kernels.upsample2x_argmax_plain(logits)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2])
    # the same taps, the same rounding order and the same strict '>'
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(8, 64, 128, 10), (2, 6, 9, 19)])
def test_upsample2x_argmax_repeats_bit_equal(card, shape):
    logits = _randn(shape, 2)
    before = kernels.launches["upsample2x_argmax"]
    first = kernels.upsample2x_argmax(logits)
    assert all(torch.equal(first, kernels.upsample2x_argmax(logits)) for _ in range(3))
    assert kernels.launches["upsample2x_argmax"] == before + 4


UPCONCAT_CASES = [
    (8, 8, 16, 64, 1280, 256),    # up1 at batch 8, 256x128 input (split K)
    (8, 16, 32, 32, 256, 128),    # up2
    (8, 32, 64, 24, 128, 64),     # up3
    (8, 64, 128, 16, 64, 32),     # up4 (no split)
    (1, 6, 10, 5, 7, 3),          # ragged tiles, channel chunks and Cout
    (2, 2, 2, 3, 17, 33),
    (2, 8, 12, 21, 37, 40),       # Cs, Cx off the 16-channel chunk and odd
    (2, 10, 20, 20, 44, 96),      # a chunk straddles Cs; 16-byte copies
    (1, 16, 34, 18, 30, 72),      # Cout off the 64-channel tile
]


def _upconcat_inputs(b, h2, w2, cs, cx, cout):
    return (_randn((b, h2, w2, cs), 2), _randn((b, h2 // 2, w2 // 2, cx), 3),
            _randn((3, 3, cs + cx, cout), 4, 0.05), _randn((cout,), 5, 0.1))


@pytest.mark.parametrize("case", UPCONCAT_CASES)
def test_fused_upconcat_matches_plain(card, case):
    args = _upconcat_inputs(*case)
    got = kernels.fused_upsample_concat_conv(*args)
    again = kernels.fused_upsample_concat_conv(*args)
    want = kernels.fused_upconcat_plain(*args)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, again)           # K splits are summed in a fixed order


@pytest.mark.parametrize("case", UPCONCAT_CASES)
def test_upconcat_plan_splits_k_only_where_the_tiles_are_few(card, case):
    b, h2, w2, cs, cx, cout = case
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits, per = kernels.upconcat_plan(b, h2, w2, cs, cx, cout, sms)
    nchunks = max(1, -(-(cs + cx) // 16))
    assert 1 <= per and (splits - 1) * per < nchunks <= splits * per
    tiles = b * -(-h2 // 8) * -(-w2 // 16) * -(-cout // (64 if cout > 32 else 32))
    if splits > 1:
        assert tiles * splits <= 2 * sms        # one wave of two resident blocks per SM
    if case[:3] == (8, 8, 16):
        assert splits > 1                       # up1: 32 tiles on the card
    if case[:3] == (8, 64, 128):
        assert splits == 1                      # up4: 512 tiles


def test_upconcat_scratch_is_the_size_the_plan_asks_for(card):
    """The launcher writes exactly splits x B*2H*2W*Cout floats of scratch:
    a guard past the end is left untouched and the result is right."""
    b, h2, w2, cs, cx, cout = 2, 6, 10, 20, 44, 40
    skip, x, w, bias = _upconcat_inputs(b, h2, w2, cs, cx, cout)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits, _ = kernels.upconcat_plan(b, h2, w2, cs, cx, cout, sms)
    assert splits > 1
    n_out = b * h2 * w2 * cout
    scratch = torch.full((splits * n_out + 1024,), 7.0, device=card)
    out = torch.empty((b, h2, w2, cout), device=card)
    kernels._launch("upconcat_conv", card, skip.data_ptr(), x.data_ptr(), w.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, h2, w2, cs, cx,
                    cout, sms, 0)
    torch.cuda.synchronize()
    assert bool((scratch[splits * n_out:] == 7.0).all())
    torch.testing.assert_close(out, kernels.fused_upconcat_plain(skip, x, w, bias),
                               rtol=RTOL, atol=ATOL)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    logits = _randn((1, 4, 8, 10), 6)
    with pytest.raises(TypeError):
        kernels.upsample2x_argmax(logits.double())
    with pytest.raises(ValueError):
        kernels.argmax_colorize(logits.transpose(1, 2), COLOR_MAP_BGR)
    with pytest.raises(ValueError):
        kernels.fused_upsample_concat_conv(
            _randn((1, 4, 4, 2), 7), _randn((1, 2, 3, 2), 8),
            _randn((3, 3, 4, 5), 9), _randn((5,), 10))


def test_pallas_model_path_launches_and_matches_plain(card):
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.models.registry import build_model

    model = build_model(ModelConfig(use_pallas=True, up_subpixel=False)).cuda().eval()
    x = _randn((2, 3, 64, 128), 11)
    kernels.reset_launches()
    with torch.inference_mode():
        fused = model(x)
        assert kernels.launches["fused_upsample_concat_conv"] == 4
        model.use_pallas = False
        plain = model(x)
    torch.testing.assert_close(fused, plain, rtol=1e-3, atol=1e-4)


def _lovasz_planes(c, p, seed):
    """errors = |onehot - softmax| [C, P] with a few errors exactly 1.0 and 0."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(p, c) * 2
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    fg = np.eye(c)[rng.randint(0, c, p)]
    errors = np.abs(fg - probs)
    errors[: min(p, 5)] = fg[: min(p, 5)]
    errors[5:9] = 0.0
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T, np.float32)).cuda()
    return as_t(errors), as_t(fg)


# rows start unaligned when P % 4 != 0 (3 and 5 classes of 1001, 4097, 262147)
@pytest.mark.parametrize("c,p", [(10, 262144), (3, 1001), (4, 7), (2, 1), (5, 4097),
                                 (3, 262147)])
def test_lovasz_kernels_match_plain(card, c, p):
    from tpuseg_torch.ops import lovasz

    e, fg = _lovasz_planes(c, p, 12)
    before = dict(kernels.launches)
    hk = lovasz.lovasz_histograms(e, fg)
    hp = lovasz.lovasz_histograms_plain(e, fg)
    assert torch.equal(hk[0], hp[0]) and torch.equal(hk[1], hp[1])
    # the error sum is summed in another order (shared-memory atomics)
    torch.testing.assert_close(hk[2], hp[2], rtol=1e-4, atol=1e-6)
    coef, _ = lovasz.coefficients(*hp)
    assert torch.equal(lovasz.lovasz_lookup(e, coef), lovasz.lovasz_lookup_plain(e, coef))
    ek, ep = e.clone().requires_grad_(True), e.clone().requires_grad_(True)
    vk, vp = lovasz.lovasz_binned_kernel(ek, fg), lovasz.lovasz_binned_plain(ep, fg)
    (vk + vp).backward()
    assert abs(float(vk.detach()) - float(vp.detach())) <= 1e-4
    assert torch.equal(ek.grad, ep.grad)
    assert kernels.launches["lovasz_histograms"] == before["lovasz_histograms"] + 2
    assert kernels.launches["lovasz_lookup"] == before["lovasz_lookup"] + 2


@pytest.mark.parametrize("offset", [0, 1])
def test_lovasz_histograms_repeat_bit_equal_counts(card, offset):
    """Counts and fg sums are bit-equal over repeated calls; offset 1 starts
    the planes one row of 1001 floats in, off 16-byte alignment."""
    from tpuseg_torch.ops import lovasz

    e, fg = _lovasz_planes(4, 1001, 14)
    e, fg = e[offset:], fg[offset:]
    first = lovasz.lovasz_histograms(e, fg)
    again = lovasz.lovasz_histograms(e, fg)
    hp = lovasz.lovasz_histograms_plain(e, fg)
    for k in (0, 1):
        assert torch.equal(first[k], again[k]) and torch.equal(first[k], hp[k])
    torch.testing.assert_close(first[2], hp[2], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("c,p", [(10, 262144), (2, (1 << 24) + 3), (1, 40 << 20), (3, 5)])
def test_lovasz_hist_plan_fills_the_card_and_keeps_blocks_exact(card, c, p):
    from tpuseg_torch.ops import lovasz

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    nblk = lovasz.lovasz_hist_plan(c, p, sms)
    assert nblk >= 1 and -(-p // nblk) < (1 << 23) + 4 * 256
    if p >= 256 * 16 * sms:
        assert c * nblk >= 2 * sms - c and c * nblk <= max(2 * sms, c * -(-p // (1 << 23)))


def test_lovasz_histogram_counts_stay_exact_past_2_24_pixels(card):
    """A class of 2**24 + 3 pixels: the kernel's counts and fg sums are the
    exact totals rounded once to float32, as the plain version's are (a
    float32 sum of ones would stop at 2**24)."""
    from tpuseg_torch.ops import lovasz

    p = (1 << 24) + 3
    e = torch.zeros((2, p), device="cuda")
    e[1, ::2] = 0.5
    fg = torch.ones_like(e)
    hk = lovasz.lovasz_histograms(e, fg)
    hp = lovasz.lovasz_histograms_plain(e, fg)
    assert torch.equal(hk[0], hp[0]) and torch.equal(hk[1], hp[1])
    assert float(hk[0][0, 0]) == float(np.float32(p)) == float(hk[1][0, 0])
    assert float(hk[0][1, 128]) == float(np.float32((p + 1) // 2))


def test_lovasz_wrappers_reject_what_the_kernels_do_not_take(card):
    from tpuseg_torch.ops import lovasz

    e, fg = _lovasz_planes(3, 64, 13)
    with pytest.raises(TypeError):
        lovasz.lovasz_histograms(e.double(), fg.double())
    with pytest.raises(ValueError):
        lovasz.lovasz_lookup(e.t(), torch.zeros(64, 256, device="cuda"))
    with pytest.raises(ValueError):
        lovasz.lovasz_histograms(e[:, ::2], fg[:, ::2])


# the encoder's 17 blocks at batch 8, 256x128: (H, W, Cin, hidden, Cout,
# stride, use_res, expand, batch), then odd H at stride 2, W off the 8-wide
# tile, no expand at stride 2, one output pixel, batch 1 at a 4x8 image with
# Cout 320, Cin and hidden off 8 (at both strides), a Cin staged in two
# pieces, and a Cout split over CTAs
MBCONV_CASES = [
    (f"block{i + 1}", (s.h, s.w, s.cin, s.hidden, s.cout, s.stride, s.use_res, s.expand, 8))
    for i, s in enumerate(inverted_residual_shapes(MobileNetV2Encoder(), 128, 256))
] + [
    ("odd-h-s2", (9, 13, 16, 96, 24, 2, False, True, 8)),
    ("ragged-w", (7, 11, 24, 144, 24, 1, True, True, 8)),
    ("t1-s2", (5, 5, 16, 16, 8, 2, False, False, 8)),
    ("one-pixel", (2, 2, 40, 40, 3, 2, False, False, 8)),
    ("batch1-4x8-cout320", (4, 8, 160, 960, 320, 1, False, True, 1)),
    ("cin-hidden-off-8", (9, 10, 13, 78, 21, 1, False, True, 2)),
    ("cin-hidden-off-8-s2", (11, 7, 20, 60, 12, 2, False, True, 3)),
    ("t1-hidden-off-8", (6, 9, 12, 12, 12, 1, True, False, 2)),
    ("cin-in-pieces", (4, 8, 400, 64, 40, 1, False, True, 2)),
    ("cout-split", (8, 16, 32, 64, 200, 1, False, True, 2)),
]


def _mbconv_args(h, w, cin, hidden, cout, seed, batch=8, expand=True):
    r = lambda shape, k, scale=1.0: _randn(shape, seed * 16 + k, scale)
    pos = lambda n, k: r((n,), k).abs() + 0.5
    return (r((batch, h, w, cin), 0), r((cin, hidden), 1, 0.2) if expand else None,
            pos(hidden, 2) if expand else None, r((hidden,), 3, 0.1) if expand else None,
            r((3, 3, hidden), 4, 0.2), pos(hidden, 5), r((hidden,), 6, 0.1),
            r((hidden, cout), 7, 0.1), pos(cout, 8), r((cout,), 9, 0.1))


@pytest.mark.parametrize("case", [c for _, c in MBCONV_CASES], ids=[i for i, _ in MBCONV_CASES])
def test_fused_inverted_residual_matches_plain(card, case):
    from tpuseg_torch.ops.mbconv import fused_inverted_residual, mbconv_plain

    h, w, cin, hidden, cout, stride, use_res, expand, batch = case
    seed = [c for _, c in MBCONV_CASES].index(case)
    args = _mbconv_args(h, w, cin, hidden, cout, seed, batch=batch, expand=expand)
    before = kernels.launches["fused_inverted_residual"]
    got = fused_inverted_residual(*args, stride=stride, use_res=use_res)
    again = fused_inverted_residual(*args, stride=stride, use_res=use_res)
    want = mbconv_plain(*args, stride=stride, use_res=use_res)
    assert kernels.launches["fused_inverted_residual"] == before + 2
    assert got.shape == (batch, h // stride, w // stride, cout)
    assert torch.equal(got, again)            # the splits are summed in a fixed order
    # fp32 sums of up to 960 terms taken in another order than cuBLAS's
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block", [15, 16, 17])
def test_fused_inverted_residual_repeats_bit_equal_where_the_hidden_channels_split(card,
                                                                                  block):
    from tpuseg_torch.ops.mbconv import fused_inverted_residual, mbconv_plan

    h, w, cin, hidden, cout, stride, use_res, expand, batch = MBCONV_CASES[block - 1][1]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert mbconv_plan(batch, h, w, cin, hidden, cout, stride, sms)[0] > 1
    args = _mbconv_args(h, w, cin, hidden, cout, 40 + block, batch=batch)
    first = fused_inverted_residual(*args, stride=stride, use_res=use_res)
    for _ in range(4):
        assert torch.equal(first, fused_inverted_residual(*args, stride=stride, use_res=use_res))


@pytest.mark.parametrize("b,h,w,cin,hidden,cout,stride", [
    (8, 64, 128, 32, 32, 16, 1), (8, 4, 8, 160, 960, 160, 1), (8, 8, 16, 96, 576, 96, 1),
    (8, 16, 32, 32, 192, 32, 1), (1, 2, 2, 40, 2000, 8, 2), (2, 3, 5, 16, 33, 16, 1)])
def test_mbconv_plan_splits_the_hidden_channels_only_where_the_tiles_are_few(
        card, b, h, w, cin, hidden, cout, stride):
    from tpuseg_torch.ops.mbconv import mbconv_plan

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits, per = mbconv_plan(b, h, w, cin, hidden, cout, stride, sms)
    # one cluster of at most 16 CTAs, each with a multiple of 8 channels
    assert 1 <= splits <= 16 and per % 8 == 0 and (splits - 1) * per < hidden <= splits * per
    if (b, h, w, hidden) == (8, 64, 128, 32):
        assert splits == 1                       # block 1: 512 tiles fill the card
    if (b, h, w, hidden) == (8, 4, 8, 960):
        assert splits >= 8                       # blocks 15-17: one 4x8 tile per image
    if (b, h, w, hidden) == (8, 8, 16, 576):
        assert splits > 1                        # blocks 12-13: two tiles per image
    if splits > 1:
        tiles = b * -(-(h // stride) // 8) * -(-(w // stride) // 16)
        assert tiles <= 2 * sms                  # split only where the tiles are few


def test_fused_inverted_residual_refuses_what_the_kernel_does_not_take(card):
    from tpuseg_torch.ops.mbconv import fused_inverted_residual, mbconv_plan

    args = _mbconv_args(8, 8, 16, 96, 24, 30, batch=1)
    with pytest.raises(RuntimeError, match="plan"):
        mbconv_plan(1, 8, 8, 16, 96, 24, 3, 132)
    with pytest.raises(TypeError):
        fused_inverted_residual(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_inverted_residual(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="different devices"):
        fused_inverted_residual(args[0].cpu(), *args[1:])
    with pytest.raises(TypeError):
        fused_inverted_residual(args[0].half(), *args[1:])
    with pytest.raises(TypeError):
        fused_inverted_residual(args[0].bfloat16(), args[1].bfloat16(), *args[2:])


# bf16 activations (ModelConfig.compute_dtype="bfloat16"): each kernel widens
# them as it reads and computes in f32, as its plain version does


@pytest.mark.parametrize("shape", [(8, 128, 256, 10), (2, 7, 33, 10)])
def test_bf16_argmax_colorize_matches_plain(card, shape):
    logits = _randn(shape, 20).bfloat16()
    before = kernels.launches["argmax_colorize"]
    cls, col = kernels.argmax_colorize(logits, COLOR_MAP_BGR)
    cls_p, col_p = kernels.argmax_colorize_plain(logits.float(), COLOR_MAP_BGR)
    assert kernels.launches["argmax_colorize"] == before + 1
    assert torch.equal(cls, cls_p)
    assert np.array_equal(col.cpu().numpy(), col_p.cpu().numpy())


@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES)
def test_bf16_upsample2x_argmax_matches_plain(card, shape):
    logits = _randn(shape, 21).bfloat16()
    before = kernels.launches["upsample2x_argmax"]
    got = kernels.upsample2x_argmax(logits)
    assert kernels.launches["upsample2x_argmax"] == before + 1
    # the widened logits through the f32 taps, rounding order and '>'
    assert torch.equal(got, kernels.upsample2x_argmax_plain(logits))
    assert torch.equal(got, kernels.upsample2x_argmax(logits.float()))


@pytest.mark.parametrize("case", UPCONCAT_CASES)
def test_bf16_fused_upconcat_matches_plain(card, case):
    skip, x, w, b = _upconcat_inputs(*case)
    skip, x = skip.bfloat16(), x.bfloat16()
    before = kernels.launches["fused_upsample_concat_conv"]
    got = kernels.fused_upsample_concat_conv(skip, x, w, b)
    assert kernels.launches["fused_upsample_concat_conv"] == before + 1
    assert got.dtype == torch.float32
    # the f32 kernel's algorithm on the widened inputs: the f32 tolerance
    torch.testing.assert_close(got, kernels.fused_upconcat_plain(skip, x, w, b),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got, kernels.fused_upsample_concat_conv(skip.float(), x.float(), w, b))


@pytest.mark.parametrize("case", [c for _, c in MBCONV_CASES], ids=[i for i, _ in MBCONV_CASES])
def test_bf16_fused_inverted_residual_matches_plain(card, case):
    from tpuseg_torch.ops.mbconv import fused_inverted_residual, mbconv_plain

    h, w, cin, hidden, cout, stride, use_res, expand, batch = case
    seed = [c for _, c in MBCONV_CASES].index(case)
    args = _mbconv_args(h, w, cin, hidden, cout, seed, batch=batch, expand=expand)
    x = args[0].bfloat16()
    before = kernels.launches["fused_inverted_residual"]
    got = fused_inverted_residual(x, *args[1:], stride=stride, use_res=use_res)
    assert kernels.launches["fused_inverted_residual"] == before + 1
    assert got.dtype == torch.bfloat16
    f32 = fused_inverted_residual(x.float(), *args[1:], stride=stride, use_res=use_res)
    # the f32 route on the widened x, rounded once to nearest even
    assert torch.equal(got, f32.bfloat16())
    want = mbconv_plain(x, *args[1:], stride=stride, use_res=use_res)
    # both round f32 values within 1e-4 of each other: one bf16 step apart
    # at most where they straddle a rounding boundary
    ulp = torch.finfo(torch.bfloat16).eps * want.float().abs().clamp(min=2.0 ** -126)
    assert bool(((got.float() - want.float()).abs() <= ulp + ATOL).all())


def test_bf16_wrappers_reject_other_half_types(card):
    logits = _randn((1, 4, 8, 10), 22)
    for fn in (kernels.upsample2x_argmax, lambda t: kernels.argmax_colorize(t, COLOR_MAP_BGR)):
        with pytest.raises(TypeError):
            fn(logits.half())
    skip, x, w, b = _upconcat_inputs(1, 4, 4, 2, 2, 5)
    with pytest.raises(TypeError):
        kernels.fused_upsample_concat_conv(skip.half(), x.half(), w, b)
    with pytest.raises(TypeError):
        kernels.fused_upsample_concat_conv(skip.bfloat16(), x, w, b)
    with pytest.raises(TypeError):
        kernels.fused_upsample_concat_conv(skip.bfloat16(), x.bfloat16(), w.bfloat16(), b)


def test_bf16_served_batch_launches_the_kernels(card, tmp_path):
    """The full-width flagship in bf16 on the kernel route, served through
    the Predictor: the decoder kernel reads the bf16 activations (4
    launches a batch); the captured batch's class maps and colours equal
    the same Predictor's eager ones; the class maps agree with a bf16
    plain-path Predictor's on 98% of the pixels and the logits lie within
    2^-4 of their largest magnitude from its logits (the two routes round
    at other places: the JAX package's own two bf16 routes agree on 98.87%
    at this size, tools/bf16_route_agreement.py)."""
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.core import graphs
    from tpuseg_torch.core.prng import make_generator
    from tpuseg_torch.core.weights import init_weights
    from tpuseg_torch.infer.predictor import Predictor
    from tpuseg_torch.models.registry import build_model

    cfg = ModelConfig(compute_dtype="bfloat16", use_pallas=True, up_subpixel=False)
    model = build_model(cfg)
    init_weights(model, make_generator(0), random_bn=True)
    path = tmp_path / "w.pth"
    torch.save(model.state_dict(), path)
    kw = dict(checkpoint=str(path), input_hw=(128, 256), batch_size=8)
    pred = Predictor(cfg, **kw)
    plain = Predictor(ModelConfig(compute_dtype="bfloat16", up_subpixel=False), **kw)
    frames = np.random.RandomState(23).randint(0, 256, (8, 180, 320, 3), np.uint8)
    kernels.reset_launches()
    classes, colors = pred(frames)
    assert kernels.launches["fused_upsample_concat_conv"] == 4
    assert kernels.launches["argmax_colorize"] == 1
    assert classes.shape == (8, 180, 320)
    replayed = pred(frames)
    assert pred._device_forward.replays() == 1
    with graphs.eager():
        eager = pred(frames)
    for got in ((classes, colors), replayed):
        assert all(np.array_equal(g, e) for g, e in zip(got, eager))
    assert (classes == plain(frames)).mean() >= 0.98
    x = torch.from_numpy(frames).cuda().float()
    from tpuseg_torch.data.augment import normalize_images
    from tpuseg_torch.ops.resize import resize_bilinear
    x = normalize_images(resize_bilinear(x, 128, 256), pred.normalize_mean,
                         pred.normalize_std).permute(0, 3, 1, 2)
    with torch.inference_mode():
        a, b = pred.model(x), plain.model(x)
    assert a.dtype == torch.float32 and bool(a.isfinite().all())
    assert float((a - b).abs().max()) <= 2 ** -4 * float(b.abs().max())


@pytest.mark.parametrize("upscale_on_host", [True, False])
def test_predict_async_with_the_pinned_fetch_equals_call(card, tmp_path, upscale_on_host):
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.core.prng import make_generator
    from tpuseg_torch.core.weights import init_weights
    from tpuseg_torch.infer.predictor import Predictor
    from tpuseg_torch.infer.video import _PinnedFetch
    from tpuseg_torch.models.registry import build_model

    cfg = ModelConfig(use_pallas=True, up_subpixel=False)
    model = build_model(cfg)
    init_weights(model, make_generator(0), random_bn=True)
    torch.save(model.state_dict(), tmp_path / "w.pth")
    pred = Predictor(cfg, checkpoint=str(tmp_path / "w.pth"), batch_size=2,
                     upscale_on_host=upscale_on_host)
    frames = np.random.RandomState(3).randint(0, 256, (2, 180, 320, 3), np.uint8)
    fetch = _PinnedFetch(2)
    outs = pred.predict_async(frames)
    assert all(t.is_cuda for t in outs)
    handle = fetch.start(outs)
    assert all(b.is_pinned() for b in handle[0])
    classes, packed = _PinnedFetch.wait(handle)
    got_cls, got_col = pred.finish_host(classes, packed, 180, 320)
    want_cls, want_col = pred(frames)
    np.testing.assert_array_equal(got_cls, want_cls)
    np.testing.assert_array_equal(got_col, want_col)


@pytest.mark.parametrize("k", [3, 5])
def test_morph_close_on_the_card_equals_the_cpu(card, k):
    from tpuseg_torch.ops.morphology import morph_close

    masks = torch.from_numpy(np.random.RandomState(k).rand(3, 360, 640) > 0.6)
    masks[:, 0, :] = masks[:, :, -1] = True
    got = morph_close(masks.cuda(), k).cpu()
    assert torch.equal(got, morph_close(masks, k))


def test_heavy_augment_captured_equals_eager(card):
    """The heavy augment inside a captured graph, with its generator
    registered: three calls (the first eager, then two replays) give the
    outputs and the generator state of three eager calls, bit for bit."""
    from tpuseg_torch.core import graphs
    from tpuseg_torch.data.augment import make_augment_fn

    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.randint(0, 256, (8, 128, 256, 3)).astype(np.uint8)).cuda()
    masks = torch.from_numpy(rng.randint(0, 10, (8, 128, 256)).astype(np.uint8)).cuda()
    fn = make_augment_fn(128, 256, heavy=True)

    def run(captured):
        g = torch.Generator(device="cuda").manual_seed(3)
        step = graphs.Captured(lambda x, y: fn(x, y, g), "heavy_augment", generators=(g,))
        outs = []
        with contextlib.nullcontext() if captured else graphs.eager():
            for _ in range(3):
                outs.append(tuple(t.clone() for t in step(imgs, masks)))
        return outs, g.get_state(), step.replays()

    (cap, cap_state, replays), (eag, eag_state, _) = run(True), run(False)
    assert replays == 2
    for (cx, cy), (ex, ey) in zip(cap, eag):
        assert torch.equal(cx, ex) and torch.equal(cy, ey)
    assert not torch.equal(cap[1][0], cap[2][0])
    assert torch.equal(cap_state, eag_state)


def test_the_packed_gather_into_pinned_memory_equals_numpy(card, tmp_path):
    from tpuseg_torch.data.combined import CombinedDataset
    from tpuseg_torch.data.pipeline import InputPipeline
    from tpuseg_torch.data.sources import PackedSource
    from tpuseg_torch.ops import native_loader
    from tpuseg_torch.tools import pack_dataset

    assert pack_dataset.main(["--kind", "synthetic", "--num_samples", "24", "--out",
                              str(tmp_path), "--width", "64", "--height", "32"]) == 0
    assert native_loader.library_path() is not None, native_loader.unavailable_reason()
    src = PackedSource(str(tmp_path), 64, 32)
    pipe = InputPipeline(CombinedDataset([src]), batch_size=8, height=32, width=64,
                         device="cuda")
    picks = pipe.sampler.sample(8)
    imgs, msks = pipe._assemble(picks)
    assert imgs.is_pinned() and msks.is_pinned()
    idx = pipe.combined.train_indices[0][[p for _, p in picks]]
    np.testing.assert_array_equal(imgs.numpy(), np.asarray(src.images)[idx])
    np.testing.assert_array_equal(msks.numpy(), np.asarray(src.masks)[idx])
    dev = pipe._put((imgs, msks))
    torch.cuda.synchronize()
    assert torch.equal(dev[0].cpu(), imgs) and torch.equal(dev[1].cpu(), msks)


def test_sharded_lovasz_on_two_ranks_sharing_the_card(card):
    """The sharded Lovász at the train shape, two ranks on this card over
    gloo: each rank launches both kernels once on its 4 rows; the global
    coefficients are bit-equal to the one-process kernel route's (counts
    and fg sums are exact), the value within its error sums' 1e-4 (float
    atomics, ROADMAP.md C5), each rank's gradient within 1e-6 of its rows
    of the one-process gradient."""
    from tests import torch_port_mesh_ranks as ranks
    from tpuseg_torch.core.mesh import launch_local
    from tpuseg_torch.ops import lovasz

    rng = np.random.RandomState(0)
    logits = (rng.randn(8, 128, 256, 10) * 2).astype(np.float32)
    targets = rng.randint(0, 10, (8, 128, 256))
    # the one-process route builds the kernels before the ranks start
    value, coef, grad = lovasz.sharded_lovasz_parts(
        torch.from_numpy(logits).cuda(), torch.from_numpy(targets).cuda(), None, False, None,
        lovasz.lovasz_histograms, lovasz.lovasz_lookup)
    out = launch_local(ranks.sharded_lovasz_card, 2, device="cuda", timeout_s=300,
                       args=(logits, targets))
    for v, c, g, rows, launched in out:
        assert launched == {"lovasz_histograms": 1, "lovasz_lookup": 1}
        assert np.array_equal(c, coef.cpu().numpy())
        assert abs(v - float(value)) <= 1e-4
        assert np.abs(g - grad[rows].cpu().numpy()).max() <= 1e-6


# the flagship's int8 conv shapes at batch 8, 256x128 (the dense 3x3 up1 at
# K = 12,096, a stride-2 stem, a depthwise 3x3 at stride 2, a 1x1, a
# dilated ASPP rate) and a batch of one at the deepest 4x8 grid (M = 32)
INT8_CONV_CASES = {  # (B, Cin, H, W, Cout, k, stride, padding, dilation, groups)
    "up1": (8, 1344, 8, 16, 256, 3, 1, 1, 1, 1),
    "stem": (8, 3, 128, 256, 32, 3, 2, 1, 1, 1),
    "depthwise_s2": (8, 96, 64, 128, 96, 3, 2, 1, 1, 96),
    "project_1x1": (8, 960, 4, 8, 320, 1, 1, 0, 1, 1),
    "aspp_rate6": (1, 1280, 4, 8, 128, 3, 1, 6, 6, 1),
}


@pytest.mark.parametrize("case", list(INT8_CONV_CASES))
def test_int8_conv_on_the_card_bit_equal_to_the_plain_version(card, case):
    """Each card route of ``ops/int8_conv.py`` gives the plain float64
    version's int32 sums bit for bit, on channels_last operands at extreme
    values (every product near 127^2)."""
    from tpuseg_torch.ops.int8_conv import int8_conv, int8_conv_plain

    b, cin, h, w, cout, k, stride, pad, dil, groups = INT8_CONV_CASES[case]
    rng = np.random.RandomState(0)
    xq = torch.from_numpy(rng.choice([-127, -1, 126, 127], (b, cin, h, w)).astype(np.int8))
    kq = torch.from_numpy(rng.choice([-127, 127, 125], (cout, cin // groups, k, k))
                          .astype(np.int8))
    want = int8_conv_plain(xq, kq, stride, pad, dil, groups)
    x = xq.cuda().contiguous(memory_format=torch.channels_last)
    got = int8_conv(x, kq.cuda(), stride, pad, dil, groups)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), want)
