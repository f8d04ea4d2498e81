"""The port's fused inverted-residual block (``tpuseg_torch/ops/mbconv.py``)
against the JAX package's ``tpuseg/ops/pallas_mbconv.py``.

On the CPU the wrapper runs its plain version, which must equal
``mbconv_reference`` at rtol and atol 1e-5 (``tests/test_mbconv.py``) at the
four specs of the JAX tests, at the encoder's 17 block configurations at a
reduced spatial size, and at odd shapes at stride 2; and the Pallas kernel
itself in interpret mode at the four specs. The kernel's CUDA side is held
against the plain version in ``tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpuseg.ops.pallas_mbconv import fold_bn_affine as jax_fold_bn_affine
from tpuseg.ops.pallas_mbconv import fused_inverted_residual as jax_fused
from tpuseg.ops.pallas_mbconv import mbconv_reference
from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core.prng import make_generator
from tpuseg_torch.core.weights import init_weights
from tpuseg_torch.models.mobilenetv2 import (InvertedResidual, MobileNetV2Encoder,
                                          inverted_residual_shapes)
from tpuseg_torch.ops import kernels
from tpuseg_torch.ops.mbconv import (fold_bn_affine, fold_inverted_residual,
                                     fused_inverted_residual, mbconv_plain)

TOL = dict(rtol=1e-5, atol=1e-5)

# the four specs of tests/test_mbconv.py
SPECS = [
    dict(b=2, h=16, w=24, cin=8, hidden=48, cout=16, stride=1, use_res=False),
    dict(b=1, h=16, w=16, cin=16, hidden=16, cout=16, stride=1, use_res=True, expand=False),
    dict(b=2, h=16, w=24, cin=8, hidden=48, cout=12, stride=2, use_res=False),
    dict(b=1, h=8, w=8, cin=24, hidden=144, cout=24, stride=1, use_res=True),
]

# the encoder's 17 blocks at full width and a 256x128 model input
ENCODER_BLOCKS = inverted_residual_shapes(MobileNetV2Encoder(), 128, 256)


def _case(rng, b, h, w, cin, hidden, cout, stride, use_res, expand=True):
    """numpy arguments as tests/test_mbconv.py's ``_case`` makes them."""
    x = rng.randn(b, h, w, cin).astype(np.float32)
    we = (rng.randn(cin, hidden) * 0.2).astype(np.float32) if expand else None
    mkv = lambda n, s: (rng.rand(n) + 0.5 if s else rng.randn(n) * 0.1).astype(np.float32)
    se, be = (mkv(hidden, True), mkv(hidden, False)) if expand else (None, None)
    return (x, we, se, be, (rng.randn(3, 3, hidden) * 0.2).astype(np.float32),
            mkv(hidden, True), mkv(hidden, False),
            (rng.randn(hidden, cout) * 0.2).astype(np.float32),
            mkv(cout, True), mkv(cout, False)), dict(stride=stride, use_res=use_res)


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _port(args, kw):
    before = dict(kernels.launches)
    out = fused_inverted_residual(*_torch(args), **kw).numpy()
    assert kernels.launches == before          # CPU tensors: the plain version
    return out


@pytest.mark.parametrize("spec", SPECS, ids=["t6", "t1-res", "t6-s2", "t6-res"])
def test_plain_matches_reference_at_the_jax_specs(spec):
    args, kw = _case(np.random.RandomState(0), **spec)
    want = np.asarray(mbconv_reference(*_jax(args), kw["stride"], kw["use_res"]))
    np.testing.assert_allclose(_port(args, kw), want, **TOL)


@pytest.mark.parametrize("spec", SPECS, ids=["t6", "t1-res", "t6-s2", "t6-res"])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(spec):
    args, kw = _case(np.random.RandomState(1), **spec)
    want = np.asarray(jax_fused(*_jax(args), **kw, interpret=True))
    np.testing.assert_allclose(_port(args, kw), want, **TOL)


@pytest.mark.parametrize("block", range(17), ids=[f"block{i + 1}" for i in range(17)])
def test_plain_matches_reference_at_the_encoder_blocks(block):
    """Full channel widths, a quarter of the spatial size, batch 1."""
    assert len(ENCODER_BLOCKS) == 17
    cin, hidden, cout, stride, use_res, expand, h, w = ENCODER_BLOCKS[block]
    args, kw = _case(np.random.RandomState(block), 1, max(2, h // 4), max(4, w // 4),
                     cin, hidden, cout, stride, use_res, expand)
    want = np.asarray(mbconv_reference(*_jax(args), stride, use_res))
    got = _port(args, kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hw,expand", [((7, 10), True), ((9, 9), False), ((5, 3), True)])
def test_plain_matches_reference_at_odd_shapes_at_stride_2(hw, expand):
    """ho = h // 2 rows, as the reference (a torch Conv2d gives (h+1)//2)."""
    cin = 16
    args, kw = _case(np.random.RandomState(5), 2, *hw, cin, 96 if expand else cin, 24, 2,
                     False, expand)
    want = np.asarray(mbconv_reference(*_jax(args), 2, False))
    got = _port(args, kw)
    assert got.shape == (2, hw[0] // 2, hw[1] // 2, 24)
    np.testing.assert_allclose(got, want, **TOL)


def test_fold_bn_affine_matches_jax():
    rng = np.random.RandomState(1)
    c = 12
    params = {"scale": rng.rand(c) + 0.5, "bias": rng.randn(c)}
    stats = {"mean": rng.randn(c), "var": rng.rand(c) + 0.1}
    params, stats = ({k: v.astype(np.float32) for k, v in d.items()} for d in (params, stats))
    for got, want in zip(fold_bn_affine(params, stats), jax_fold_bn_affine(params, stats)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("index", [1, 2, 4, 14], ids=["t1", "t6-s2", "t6-res", "t6-s2-160"])
def test_plain_fed_from_a_port_block_equals_its_forward(index):
    """``fold_inverted_residual`` ties the kernel's function to the model:
    the plain version on a port InvertedResidual's folded eval weights gives
    that block's forward."""
    enc = MobileNetV2Encoder(width_mult=0.5)
    init_weights(enc, make_generator(index), random_bn=True)
    block = enc.features[index].eval()
    cin = block.conv[0][0].in_channels
    x = torch.from_numpy(np.random.RandomState(index).randn(2, cin, 12, 20).astype(np.float32))
    with torch.no_grad():
        want = block(x).permute(0, 2, 3, 1)
    folded = fold_inverted_residual(block)
    got = fused_inverted_residual(x.permute(0, 2, 3, 1).contiguous(), **folded)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_block_shapes_are_those_of_the_blocks_inputs_in_a_forward():
    """``inverted_residual_shapes`` (which the card checks read) against
    the inputs that each block really receives, at a ragged input size."""
    enc = MobileNetV2Encoder(width_mult=0.5).eval()
    seen = []
    for layer in enc.features:
        if isinstance(layer, InvertedResidual):
            layer.register_forward_pre_hook(lambda m, args: seen.append(args[0].shape))
    with torch.no_grad():
        enc(torch.zeros(1, 3, 70, 46))
    shapes = inverted_residual_shapes(enc, 70, 46)
    assert len(shapes) == len(seen) == 17
    assert [(s.cin, s.h, s.w) for s in shapes] == [(c, h, w) for _, c, h, w in seen]
    blocks = [m for m in enc.features if isinstance(m, InvertedResidual)]
    for s, block in zip(shapes, blocks):
        folded = fold_inverted_residual(block)
        assert (s.hidden, s.cout, s.stride, s.use_res, s.expand) == (
            folded["wd"].shape[-1], folded["wp"].shape[-1], folded["stride"],
            folded["use_res"], folded["we"] is not None)


def test_wrapper_refuses_what_the_block_cannot_be():
    args, kw = _case(np.random.RandomState(2), **SPECS[0])
    t = _torch(args)
    with pytest.raises(ValueError, match="use_res"):
        fused_inverted_residual(*t, stride=2, use_res=True)
    with pytest.raises(ValueError, match="stride"):
        fused_inverted_residual(*t, stride=3)
    with pytest.raises(ValueError, match="wp"):
        fused_inverted_residual(*t[:7], t[7][:, :3].t(), *t[8:])
    # bf16 activations are taken (computed in f32, written in bf16)
    out = fused_inverted_residual(t[0].bfloat16(), *t[1:])
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, fused_inverted_residual(t[0].bfloat16().float(), *t[1:]).bfloat16())
    assert ModelConfig().compute_dtype == "float32"
