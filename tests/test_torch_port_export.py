"""Parity of the port's quantization and export (``tpuseg_torch/export``) with the JAX package.

The same seeded numpy weights and inputs go through the JAX package (on the
CPU) and the port (``device="cpu"``), at small sizes
(``tests/torch_port_quant_inputs.py``: ``unet`` base_filters 8, the
MobileNetV2 families at width_mult 0.25, 32x64). Tolerances:

- ``fold_batchnorm``, ``quantize_int8``/``dequantize_int8`` and
  ``cast_params`` on ``state_dict_from_flax(v)``: bit-equal to
  ``state_dict_from_flax`` of the JAX result, per family.
- ``export_model``: the artifact within rel 1e-5 of the live model (1e-2
  for fp16 weights); the Predictor serves it with the live model's maps.
- ``convert``: each format's rc and self-check (SavedModel and TFLite
  where TensorFlow imports); its ONNX file byte-equal to the JAX
  ``convert.py``'s on the same weights.
- ``eval_quantized``: the four weight-only variants' mIoU within 1e-4 of
  the JAX tool's on the same weights, ``int8_full``'s within 1e-2.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax.tree_util as jtu

from tests.torch_port_quant_inputs import (FAMILIES, HW, family, images, jax_tool,  # noqa: F401
                                           two_threads)
from tpuseg.export import quantize as jax_quantize
from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core.weights import state_dict_from_flax
from tpuseg_torch.export import int8_full, quantize
from tpuseg_torch.export.torch_export import export_model, load_exported
from tpuseg_torch.infer.predictor import Predictor
from tpuseg_torch.models.registry import build_model



def assert_sd_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# export/quantize.py


@pytest.mark.parametrize("name", list(FAMILIES))
def test_quantize_functions_bit_equal_jax(name):
    _, v, _ = family(name)
    sd = state_dict_from_flax(v)
    assert_sd_equal(quantize.fold_batchnorm(sd),
                    state_dict_from_flax(jax_quantize.fold_batchnorm(v)))
    jq = jax_quantize.quantize_int8(v["params"])
    assert_sd_equal(quantize.dequantize_int8(quantize.quantize_int8(sd)),
                    state_dict_from_flax({"params": jax_quantize.dequantize_int8(jq),
                                          "batch_stats": v["batch_stats"]}))
    # the int8 values and scales themselves, put where the kernels were
    node = lambda leaf: isinstance(leaf, dict) and "__int8__" in leaf
    values = jtu.tree_map(lambda n: n["__int8__"] if node(n) else n, jq, is_leaf=node)
    scales = jtu.tree_map(lambda n: n["__scale__"].reshape(1, 1, 1, -1) if node(n) else n, jq,
                          is_leaf=node)
    want_q = state_dict_from_flax({"params": values, "batch_stats": v["batch_stats"]})
    want_s = state_dict_from_flax({"params": scales, "batch_stats": v["batch_stats"]})
    got = quantize.quantize_int8(sd)
    n_conv = 0
    for k, g in got.items():
        if isinstance(g, dict):
            n_conv += 1
            assert g["__int8__"].dtype == torch.int8 and torch.equal(g["__int8__"], want_q[k])
            assert torch.equal(g["__scale__"], want_s[k].reshape(-1))
        else:
            assert torch.equal(g, sd[k])
    assert n_conv == sum(1 for k, t in sd.items() if k.endswith(".weight") and t.ndim == 4)
    for jdt, tdt in ((jnp.float16, torch.float16), (jnp.bfloat16, torch.bfloat16)):
        want = jax_quantize.cast_params(v["params"], jdt)
        got = quantize.cast_params(sd, tdt)
        want = state_dict_from_flax({"params": jtu.tree_map(
            lambda a: np.asarray(a.astype(jnp.float32)), want),
            "batch_stats": v["batch_stats"]})
        for k, t in got.items():
            stat = k.endswith(quantize.STAT_SUFFIXES)
            assert t.dtype == (sd[k].dtype if stat or not t.is_floating_point() else tdt), k
            assert torch.equal(t.to(want[k].dtype), want[k]), k


def test_fold_batchnorm_biasfree_conv_keeps_shift():
    """A bias-free conv (the whole encoder) keeps the folded shift in its
    BatchNorm's bias, and the folded model computes the same function
    (test_export.py's case, on the port)."""
    _, v, model = family("mobilenetv2_unet")
    sd = state_dict_from_flax(v)
    folded = quantize.fold_batchnorm(sd)
    stem_bn = "backbone.features.0.1"
    assert "backbone.features.0.0.bias" not in folded
    assert torch.equal(folded[f"{stem_bn}.weight"], torch.ones_like(sd[f"{stem_bn}.weight"]))
    assert not torch.equal(folded[f"{stem_bn}.bias"], sd[f"{stem_bn}.bias"])
    assert torch.equal(folded["up1.conv.conv.0.bias"], torch.zeros_like(sd["up1.conv.conv.0.bias"]))
    x = torch.from_numpy(images(0)).permute(0, 3, 1, 2)
    model.eval()
    with torch.no_grad():
        model.load_state_dict(sd)
        want = model(x)
        model.load_state_dict(folded)
        got = model(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# export/torch_export.py


@pytest.fixture(scope="module")
def unet_weights():
    _, v, model = family("unet")
    return model, state_dict_from_flax(v)


def live(model, sd, x):
    model.load_state_dict(sd)
    with torch.no_grad():
        return model.eval()(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.abs().max())


def test_export_model_symbolic_batch_round_trip(unet_weights, tmp_path):
    model, sd = unet_weights
    path = str(tmp_path / "m.pt2")
    data, _ = export_model(model, sd, *HW, path)
    with open(path, "rb") as f:
        assert f.read() == data
    call = load_exported(path)
    for b in (1, 3):
        x = torch.from_numpy(images(b, n=b))
        assert rel(call(x), live(model, sd, x)) < 1e-5


def test_export_model_static_batch_refuses_another_size(unet_weights, tmp_path):
    model, sd = unet_weights
    path = str(tmp_path / "m2.pt2")
    export_model(model, sd, *HW, path, batch=2)
    call = load_exported(path)
    x = torch.from_numpy(images(0))
    assert rel(call(x), live(model, sd, x)) < 1e-5
    with pytest.raises(Exception, match="size"):
        call(torch.from_numpy(images(0, n=3)))


def test_export_model_fp16_stores_fp16_and_fold_bn_off_keeps_bn(unet_weights, tmp_path):
    model, sd = unet_weights
    x = torch.from_numpy(images(5))
    d16, ep16 = export_model(model, sd, *HW, str(tmp_path / "h.pt2"), batch=2,
                             dtype="float16")
    stored = {n: t.dtype for n, t in ep16.state_dict.items()}
    n_stats = sum(1 for k in sd if k.endswith((".running_mean", ".running_var")))
    assert sum(dt == torch.float32 for dt in stored.values()) == n_stats
    assert sum(dt == torch.float16 for dt in stored.values()) == sum(
        1 for k, t in sd.items() if t.is_floating_point()) - n_stats
    assert rel(load_exported(str(tmp_path / "h.pt2"))(x), live(model, sd, x)) < 1e-2
    _, ep = export_model(model, sd, *HW, str(tmp_path / "nofold.pt2"), batch=2, fold_bn=False)
    bn_var = [t for t in ep.state_dict.values() if t.dtype == torch.float32 and t.ndim == 1]
    assert any(not torch.allclose(t, torch.full_like(t, 1 - 1e-5)) for t in bn_var)
    assert rel(load_exported(str(tmp_path / "nofold.pt2"))(x), live(model, sd, x)) < 1e-5
    with pytest.raises(ValueError, match="use_pallas=false"):
        export_model(build_model(ModelConfig(use_pallas=True, width_mult=0.25)), sd, *HW, "")


def test_predictor_serves_the_artifact_as_the_live_model(unet_weights, tmp_path):
    model, sd = unet_weights
    path = str(tmp_path / "serve.pt2")
    export_model(model, sd, *HW, path)
    pth = tmp_path / "w.pth"
    torch.save(sd, pth)
    cfg = ModelConfig(**FAMILIES["unet"])
    kw = dict(input_hw=HW, batch_size=2, device="cpu", colorize_on_device=True)
    art = Predictor(cfg, checkpoint="ignored-by-the-artifact", artifact=path, **kw)
    ref = Predictor(cfg, checkpoint=str(pth), **kw)
    frames = np.random.RandomState(6).randint(0, 256, (2, 48, 80, 3), np.uint8)
    (c1, p1), (c2, p2) = art(frames), ref(frames)
    assert art.artifact_call is not None and not art.int8
    assert np.array_equal(c1, c2) and np.array_equal(p1, p2)


# ---------------------------------------------------------------------------
# the entry points


@pytest.fixture(scope="module")
def unet_pth(tmp_path_factory, unet_weights):
    path = tmp_path_factory.mktemp("w") / "unet.pth"
    torch.save(unet_weights[1], path)
    return str(path)


BASE_FLAGS = ["--platform=cpu", "--model.name=unet", "--model.base_filters=8",
              "--data.height=32", "--data.width=64"]
CONVERT_CASES = {
    "stablehlo": ([], 0, "Export is valid!"),
    "stablehlo_static_fp16": (["--export.batch=2", "--export.dtype=float16"], 0,
                              "Export is valid!"),
    "int8_weights": (["--export.dtype=int8"], 0, "Export is valid!"),
    "quantized": (["--export.format=quantized", "--export.calib_batches=1"], 0,
                  "int8 vs fp32 mask agreement"),
    "onnx": (["--export.format=onnx"], 0, "Export is valid!"),
    "onnx_fp16": (["--export.format=onnx", "--export.dtype=float16"], 1, "float32 graphs only"),
    "savedmodel": (["--export.format=savedmodel"], 0, "Export is valid!"),
    "tflite": (["--export.format=tflite"], 0, "Export is valid!"),
    # the TF graph computes the fp32 function, checked against fp32 compute;
    # its distance from the served bf16 model is printed beside, naming C19
    "savedmodel_bf16_compute": (["--export.format=savedmodel",
                                 "--model.compute_dtype=bfloat16"], 0, "Export is valid!"),
    "use_pallas": (["--model.name=mobilenetv2_unet", "--model.width_mult=0.25",
                    "--model.use_pallas=true"], 1, "use_pallas=false"),
    "quant_checkpoint_to_onnx": (["--export.format=onnx"], 1, "'quant' collection"),
}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_convert_formats(case, unet_pth, tmp_path, capsys):
    from tpuseg_torch.convert import main

    extra, want_rc, said = CONVERT_CASES[case]
    if case.startswith(("savedmodel", "tflite")):
        pytest.importorskip("tensorflow")
    out = str(tmp_path / "artifact")
    ckpt = unet_pth
    if case == "quant_checkpoint_to_onnx":
        ckpt = str(tmp_path / "int8")
        sd = torch.load(unet_pth, weights_only=True)
        int8_full.save_quantized(ckpt, sd, {"inc.conv.conv.0": {
            "kernel_q": torch.zeros(8, 3, 3, 3, dtype=torch.int8),
            "kernel_scale": torch.ones(8), "act_scale": torch.tensor(0.1)}})
    rc = main(BASE_FLAGS + [f"--export.checkpoint={ckpt}", f"--export.output={out}"] + extra)
    text = capsys.readouterr().out
    assert rc == want_rc and said in text, text
    if case == "savedmodel_bf16_compute":
        assert "Against the served bfloat16 model" in text and "C19" in text, text
    if case == "quantized":
        p = Predictor(ModelConfig(**FAMILIES["unet"]), checkpoint=out, input_hw=HW,
                      batch_size=2, device="cpu")
        assert p.int8 and "Calibrated 15 convs" in text
    if case == "onnx":
        import convert as jax_convert

        jax_out = str(tmp_path / "jax.onnx")
        assert jax_convert.main(BASE_FLAGS + [f"--export.checkpoint={unet_pth}",
                                              f"--export.output={jax_out}"] + extra) == 0
        assert open(out, "rb").read() == open(jax_out, "rb").read()


def tool_json(text: str) -> dict:
    return json.loads(text[text.index("{"): text.rindex("}") + 1])


def test_eval_quantized_matches_jax(unet_pth, capsys):
    from tpuseg_torch.tools import eval_quantized as port_tool

    flags = ["--platform=cpu", f"--checkpoint={unet_pth}", "--model=unet", "--base_filters=8",
             "--samples=16", "--width=64", "--height=32"]
    jax_rc = jax_tool("eval_quantized").main(flags)
    want_text = capsys.readouterr().out
    port_rc = port_tool.main(flags)
    got_text = capsys.readouterr().out
    want, got = tool_json(want_text), tool_json(got_text)
    assert list(got) == list(want) == ["fp32", "bn_folded", "int8_weights", "fp16_weights",
                                       "int8_full"]
    for name in ("fp32", "bn_folded", "int8_weights", "fp16_weights"):
        assert abs(got[name]["miou"] - want[name]["miou"]) <= 1e-4, name
    assert abs(got["int8_full"]["miou"] - want["int8_full"]["miou"]) <= 1e-2
    verdict = lambda t: t.strip().splitlines()[-1]
    assert verdict(got_text).startswith("acceptance (all variants within 1 mIoU point): ")
    assert port_rc == (0 if verdict(got_text).endswith("PASS") else 1)
    assert jax_rc == (0 if verdict(want_text).endswith("PASS") else 1)
