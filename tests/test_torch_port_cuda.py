"""Card-only tests of the port's CUDA kernels against their plain versions.

Each kernel runs at the serving and training paths' shapes and at ragged
ones, on the card, beside its plain PyTorch version on the same inputs. Without a CUDA
card every test here skips (the decision is taken inside the ``card``
fixture, so every worker collects the same tests). On the machine with the
card, whose Python has no JAX (which ``tests/conftest.py`` imports):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

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


@pytest.mark.parametrize("shape", [(8, 64, 128, 10), (2, 5, 7, 3), (1, 1, 1, 10)])
def test_upsample2x_argmax_matches_plain(card, shape):
    logits = _randn(shape, 1)
    got = kernels.upsample2x_argmax(logits)
    want = kernels.upsample2x_argmax_plain(logits)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2])
    up = upsample2x_bilinear(logits, align_corners=True).topk(2, dim=-1).values
    near = (up[..., 0] - up[..., 1]) < NEAR_TIE
    assert not bool(((got != want) & ~near).any())


@pytest.mark.parametrize("case", [
    (8, 8, 16, 64, 1280, 256),    # up1 at batch 8, 256x128 input
    (8, 16, 32, 32, 256, 128),    # up2
    (8, 32, 64, 24, 128, 64),     # up3
    (8, 64, 128, 16, 64, 32),     # up4
    (1, 6, 10, 5, 7, 3),          # ragged tiles, channel chunks and Cout
    (2, 2, 2, 3, 17, 33),
])
def test_fused_upconcat_matches_plain(card, case):
    b, h2, w2, cs, cx, cout = case
    skip = _randn((b, h2, w2, cs), 2)
    x = _randn((b, h2 // 2, w2 // 2, cx), 3)
    w = _randn((3, 3, cs + cx, cout), 4, 0.05)
    bias = _randn((cout,), 5, 0.1)
    got = kernels.fused_upsample_concat_conv(skip, x, w, bias)
    want = kernels.fused_upconcat_plain(skip, x, w, bias)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


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


@pytest.mark.parametrize("c,p", [(10, 262144), (3, 1001), (4, 7), (2, 1)])
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
# stride, use_res, expand), then odd H at stride 2, W off the 8-wide tile, no
# expand at stride 2, and one output pixel
MBCONV_SHAPES = [
    (s.h, s.w, s.cin, s.hidden, s.cout, s.stride, s.use_res, s.expand)
    for s in inverted_residual_shapes(MobileNetV2Encoder(), 128, 256)
] + [
    (9, 13, 16, 96, 24, 2, False, True), (7, 11, 24, 144, 24, 1, True, True),
    (5, 5, 16, 16, 8, 2, False, False), (2, 2, 40, 40, 3, 2, False, False),
]


def _mbconv_args(h, w, cin, hidden, cout, seed, batch=8, expand=True):
    r = lambda shape, k, scale=1.0: _randn(shape, seed * 16 + k, scale)
    pos = lambda n, k: r((n,), k).abs() + 0.5
    return (r((batch, h, w, cin), 0), r((cin, hidden), 1, 0.2) if expand else None,
            pos(hidden, 2) if expand else None, r((hidden,), 3, 0.1) if expand else None,
            r((3, 3, hidden), 4, 0.2), pos(hidden, 5), r((hidden,), 6, 0.1),
            r((hidden, cout), 7, 0.1), pos(cout, 8), r((cout,), 9, 0.1))


@pytest.mark.parametrize("case", MBCONV_SHAPES,
                         ids=[f"block{i + 1}" for i in range(17)] + ["odd-h-s2", "ragged-w",
                                                                     "t1-s2", "one-pixel"])
def test_fused_inverted_residual_matches_plain(card, case):
    from tpuseg_torch.ops.mbconv import fused_inverted_residual, mbconv_plain

    h, w, cin, hidden, cout, stride, use_res, expand = case
    args = _mbconv_args(h, w, cin, hidden, cout, MBCONV_SHAPES.index(case), expand=expand)
    before = kernels.launches["fused_inverted_residual"]
    got = fused_inverted_residual(*args, stride=stride, use_res=use_res)
    again = fused_inverted_residual(*args, stride=stride, use_res=use_res)
    want = mbconv_plain(*args, stride=stride, use_res=use_res)
    assert kernels.launches["fused_inverted_residual"] == before + 2
    assert got.shape == (8, h // stride, w // stride, cout)
    assert torch.equal(got, again)            # the splits are summed in a fixed order
    # fp32 sums of up to 960 terms taken in another order than cuBLAS's
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,h,w,hidden,stride", [
    (8, 64, 128, 32, 1), (8, 4, 8, 960, 1), (8, 8, 16, 384, 1), (1, 2, 2, 2000, 2),
    (2, 3, 5, 33, 1)])
def test_mbconv_plan_covers_the_hidden_channels_in_at_most_six_chunks(card, b, h, w, hidden,
                                                                      stride):
    from tpuseg_torch.ops.mbconv import mbconv_plan

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits, per = mbconv_plan(b, h, w, hidden, stride, sms)
    nchunks = -(-hidden // 32)
    assert 1 <= per <= 6 and (splits - 1) * per < nchunks <= splits * per
    if (b, h, w, hidden) == (8, 64, 128, 32):
        assert (splits, per) == (1, 1)           # block 1: many tiles, one chunk
    if (b, h, w, hidden) == (8, 4, 8, 960):
        assert splits > 5                         # blocks 15-17: the hidden split widely


def test_fused_inverted_residual_refuses_what_the_kernel_does_not_take(card):
    from tpuseg_torch.ops.mbconv import fused_inverted_residual, mbconv_plan

    args = _mbconv_args(8, 8, 16, 96, 24, 30, batch=1)
    with pytest.raises(RuntimeError, match="plan"):
        mbconv_plan(1, 8, 8, 96, 3, 132)
    with pytest.raises(TypeError):
        fused_inverted_residual(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_inverted_residual(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="different devices"):
        fused_inverted_residual(args[0].cpu(), *args[1:])
    with pytest.raises(NotImplementedError, match="bf16"):
        fused_inverted_residual(args[0].bfloat16(), *args[1:])
