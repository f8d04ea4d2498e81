"""The port's ONNX export (``tpuseg_torch/export/onnx_*``) against the JAX package's.

The same seeded flax weights (BatchNorm jittered) go through both
exporters at 32x64: the port's ``export_onnx(model, state_dict_from_flax(v))``
writes the same bytes as the JAX ``export_onnx(model, v)``, for the five
families, a wider ``width_mult``, ``upsample_head=False`` and a static
batch; the port's ``run_model`` (torch ops) is within rel 1e-6 of the JAX
``onnx_run`` and within rel 1e-5 of the port's live model (the
self-check's bound), on three families that cover the op set; ``check_model`` finds the same problems; the copied
codec writes and reads the same bytes as the JAX one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from tests.torch_port_quant_inputs import two_threads  # noqa: F401 (autouse)
from tpuseg.configs import ModelConfig as JaxModelConfig
from tpuseg.export import onnx_proto as jax_op
from tpuseg.export.onnx_export import export_onnx as jax_export_onnx
from tpuseg.export.onnx_run import check_model as jax_check_model
from tpuseg.export.onnx_run import run_model as jax_run_model
from tpuseg.models.mobilenetv2_unet import MobileNetV2UNet as JaxMobileNetV2UNet
from tpuseg.models.registry import build_model as jax_build_model
from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core.weights import flax_variables, state_dict_from_flax
from tpuseg_torch.export import onnx_proto as op
from tpuseg_torch.export.onnx_export import export_onnx
from tpuseg_torch.export.onnx_run import check_model, run_model
from tpuseg_torch.models.registry import build_model

HW = (32, 64)
CASES = {   # name -> (model config, export batch)
    "unet": (dict(name="unet", base_filters=8), -1),
    "light_unet": (dict(name="light_unet", base_filters=8), -1),
    "mobilenetv2_unet": (dict(name="mobilenetv2_unet", width_mult=0.25), -1),
    "mobilenetv2_fpn": (dict(name="mobilenetv2_fpn", width_mult=0.25, base_filters=16), -1),
    "mobilenetv2_deeplab": (dict(name="mobilenetv2_deeplab", width_mult=0.25,
                                 base_filters=16), -1),
    "width_mult_0.5": (dict(name="mobilenetv2_unet", width_mult=0.5), -1),
    "no_upsample_head": (dict(name="mobilenetv2_unet", width_mult=0.25), -1),
    "static_batch": (dict(name="unet", base_filters=8), 2),
}
# the interpreter's op set: MaxPool and half-pixel Resize (unet), Clip and
# align_corners Resize (the flagship), dilated convs, GlobalAveragePool and
# nearest Resize (deeplab)
RUN_CASES = ("unet", "mobilenetv2_unet", "mobilenetv2_deeplab")
# cases whose weights are another case's (the same parameter tree)
SAME_WEIGHTS = {"no_upsample_head": "mobilenetv2_unet", "static_batch": "unet"}


def jitter(variables, seed=5):
    """Non-trivial BN params/stats (test_onnx.py's ``_jitter_bn``)."""
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


_exports: dict = {}


def exported(case: str):
    """(JAX bytes, port bytes, JAX variables, port model) of one case."""
    if case not in _exports:
        kw, batch = CASES[case]
        if case == "no_upsample_head":
            jm = JaxMobileNetV2UNet(output_channels=10, width_mult=0.25, upsample_head=False)
        else:
            jm = jax_build_model(JaxModelConfig(**kw))
        model = build_model(ModelConfig(**kw))
        if case in SAME_WEIGHTS:
            v = exported(SAME_WEIGHTS[case])[2]
        elif case == "width_mult_0.5":
            # the port's seeded weights as a flax tree (its structure is held
            # to flax's init in the width 0.25 case): a JAX init at this
            # width takes 12 s to compile
            v = jitter(flax_variables(model, model.state_dict()))
        else:
            v = jitter(jax.jit(lambda k: jm.init(k, jnp.zeros((1, *HW, 3)), train=False))(
                jax.random.PRNGKey(0)))
        if case == "no_upsample_head":
            model.upsample_head = False
        sd = state_dict_from_flax(v)
        model.load_state_dict(sd)
        _exports[case] = (jax_export_onnx(jm, v, *HW, batch=batch),
                          export_onnx(model, sd, *HW, batch=batch), v, model)
    return _exports[case]


@pytest.mark.parametrize("case", list(CASES))
def test_onnx_bytes_equal_jax(case, tmp_path):
    want, got, _, model = exported(case)
    assert got == want
    path = tmp_path / "m.onnx"
    sd = state_dict_from_flax(exported(case)[2])
    assert export_onnx(model, sd, *HW, path=str(path), batch=CASES[case][1]) == want
    assert path.read_bytes() == want
    assert check_model(got) == []


@pytest.mark.parametrize("name", RUN_CASES)
def test_run_model_matches_jax_onnx_run_and_the_live_model(name):
    want_bytes, got_bytes, _, model = exported(name)
    x = np.random.RandomState(1).rand(2, 3, *HW).astype(np.float32)
    want = jax_run_model(want_bytes, {"input": x})["output"]
    got = run_model(got_bytes, {"input": x})["output"]
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # torch feeds stay on their device and give the same values
    fed = run_model(got_bytes, {"input": torch.from_numpy(x)})["output"]
    np.testing.assert_array_equal(fed, got)
    with torch.no_grad():
        live = model.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - live).max() < 1e-5 * np.abs(live).max()


def _graph(nodes, outputs, opset=True):
    graph = op.graph_proto(nodes, "g", inputs=[op.value_info_proto("x", op.FLOAT, [1])],
                           outputs=[op.value_info_proto(o, op.FLOAT, [1]) for o in outputs],
                           initializers=[])
    model = op.parse_model(op.model_proto(graph))
    if not opset:
        model.pop("opset_import")
    return model


@pytest.mark.parametrize("case", ["unresolved_input", "output_never_produced",
                                  "missing_opset", "valid"])
def test_check_model_finds_the_same_problems(case):
    nodes = {"unresolved_input": [op.node_proto("Relu", ["ghost"], ["y"])],
             "output_never_produced": [op.node_proto("Relu", ["x"], ["z"])],
             "missing_opset": [op.node_proto("Relu", ["x"], ["y"])],
             "valid": [op.node_proto("Relu", ["x"], ["y"])]}[case]
    model = _graph(nodes, ["y"], opset=case != "missing_opset")
    got = check_model(model)
    assert got == jax_check_model(model)
    assert (got == []) == (case == "valid")


def test_codec_copy_writes_and_reads_the_jax_bytes():
    rng = np.random.RandomState(0)
    for dtype in (np.float32, np.float16, np.float64, np.int8, np.uint8, np.int32, np.int64,
                  np.bool_):
        arr = (rng.randn(3, 4) * 50).astype(dtype)
        data = op.tensor_proto("t", arr)
        assert data == jax_op.tensor_proto("t", arr)
        name, back = op.parse_tensor(data)
        assert name == "t" and back.dtype == arr.dtype and np.array_equal(back, arr)
    node = dict(kernel_shape=[3, 3], pads=[-1, 0, -(2**40), 3], epsilon=1e-5, mode="linear")
    assert op.node_proto("X", ["a", ""], ["y"], name="n", **node) == jax_op.node_proto(
        "X", ["a", ""], ["y"], name="n", **node)
    assert op.parse_node(op.node_proto("X", [], ["y"], **node))["attrs"]["pads"] == node["pads"]


def test_export_onnx_rejects_the_sizes_jax_rejects():
    for kw, hw in ((dict(name="mobilenetv2_unet", width_mult=0.25), (48, 64)),
                   (dict(name="unet", base_filters=8), (36, 64))):
        jm = jax_build_model(JaxModelConfig(**kw))
        model = build_model(ModelConfig(**kw))
        with pytest.raises(ValueError) as want:
            jax_export_onnx(jm, {"params": {}, "batch_stats": {}}, *hw)
        with pytest.raises(ValueError) as got:
            export_onnx(model, model.state_dict(), *hw)
        assert str(got.value).replace(type(model).__name__, "M") == \
            str(want.value).replace(type(jm).__name__, "M")
