"""Shared inputs of the port's quantization and export tests
(``tests/test_torch_port_export.py``, ``tests/test_torch_port_int8.py``):
the five families at a small size with jittered BatchNorm, the JAX
calibration of each, and the tools of the repo imported fresh."""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from tpuseg.configs import ModelConfig as JaxModelConfig
from tpuseg.export import int8_full as jax_int8
from tpuseg.models.registry import build_model as jax_build_model
from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.models.registry import build_model

HW = (32, 64)
FAMILIES = {
    "unet": dict(name="unet", base_filters=8),
    "light_unet": dict(name="light_unet", base_filters=8),
    "mobilenetv2_unet": dict(name="mobilenetv2_unet", width_mult=0.25),
    "mobilenetv2_fpn": dict(name="mobilenetv2_fpn", width_mult=0.25, base_filters=16),
    "mobilenetv2_deeplab": dict(name="mobilenetv2_deeplab", width_mult=0.25, base_filters=16),
}
CALIB_SEEDS = (1, 2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name: str):
    """tools/<name>.py of the repo, imported fresh."""
    spec = importlib.util.spec_from_file_location(f"{name}_under_test",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        del sys.modules[spec.name]
    return mod


def jitter(variables, seed=5):
    """Non-trivial BN affine and statistics (test_export.py's fixture)."""
    rng = np.random.RandomState(seed)

    def stats(p, x):
        lo, hi = (0.5, 1.5) if "var" in str(p) else (-0.05, 0.05)
        return rng.uniform(lo, hi, x.shape).astype(np.float32)

    def params(p, x):
        s = str(p)
        if "'bn'" in s:
            lo, hi = (0.5, 1.5) if "scale" in s else (-0.05, 0.05)
            return rng.uniform(lo, hi, x.shape).astype(np.float32)
        return np.asarray(x)

    return {"params": jtu.tree_map_with_path(params, variables["params"]),
            "batch_stats": jtu.tree_map_with_path(stats, variables["batch_stats"])}


_variables: dict = {}
_quant: dict = {}


def family(name: str, **over):
    """(JAX model, jittered numpy variables, port model) of one family;
    ``over`` changes the configuration, not the weights."""
    kw = {**FAMILIES[name], **over}
    jm = jax_build_model(JaxModelConfig(**kw))
    if name not in _variables:
        v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, *HW, 3)), train=False))(
            jax.random.PRNGKey(0))
        _variables[name] = jitter(v)
    return jm, _variables[name], build_model(ModelConfig(**kw))


def jax_quant(name: str):
    """The JAX ``calibrate`` of a family on two batches, both forwards in
    float64 (under x64; the up blocks' subpixel rewrite off, as
    convert.py calibrates)."""
    if name not in _quant:
        jm, v, _ = family(name, up_subpixel=False)
        jax.config.update("jax_enable_x64", True)
        try:
            cast = lambda t: jtu.tree_map(lambda a: np.asarray(a, np.float64), t)
            _quant[name] = jax_int8.calibrate(
                Jitted(jm.clone(dtype=jnp.float64)),
                {"params": cast(v["params"]), "batch_stats": cast(v["batch_stats"])},
                [jnp.asarray(images(s), jnp.float64) for s in CALIB_SEEDS])
        finally:
            jax.config.update("jax_enable_x64", False)
    return _quant[name]


def images(seed, n=2, dtype=np.float32):
    return np.random.RandomState(seed).randn(n, *HW, 3).astype(dtype)


class Jitted:
    """A JAX model whose ``apply`` (the one ``calibrate`` calls) is jitted:
    the same forward, compiled once instead of run op by op."""

    def __init__(self, model):
        self._f = jax.jit(lambda v, x: model.apply(v, x, train=False,
                                                   mutable=["intermediates"]))

    def apply(self, v, x, train, mutable):
        return self._f(v, x)




@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads (the suite runs several workers on a few cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
