"""The port's SavedModel and TFLite export (``tpuseg_torch/export/tf_export.py``)
against the JAX package's ``tpuseg/export/tf_export.py``.

The same jittered weights (``tests/torch_port_quant_inputs.py``: the unet at
base_filters 8 and the flagship at width_mult 0.25, 32x64) are exported by
both packages; the port's TF graph is lowered from its ONNX graph, the JAX
one by jax2tf. Tolerances, relative to the largest logit:

- SavedModel (polymorphic batch, run at batch 2 and 6) and fp32 TFLite:
  within 1e-4 of the JAX model, of the port's live model and, for the
  unet, of the JAX SavedModel and TFLite artifacts (float32 sums in other
  orders; convert's own bound is 1e-3);
- fp16-weight TFLite: within 1e-2 of the JAX fp16 artifact, the JAX model
  and the live model (convert's bound for reduced weights).

TensorFlow is imported by the fixture that needs it (one worker of the
suite pays its import); the TF-less host is simulated by refusing the
import, and ``convert`` must exit 1 naming TensorFlow there.
"""

from __future__ import annotations

import sys

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_quant_inputs import HW, family, two_threads  # noqa: F401
from tpuseg.export import tf_export as jax_tf
from tpuseg_torch.core.weights import state_dict_from_flax
from tpuseg_torch.export import tf_export

FP32_RTOL, FP16_RTOL = 1e-4, 1e-2
NAMES = ("unet", "mobilenetv2_unet")


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _inputs(n, seed=0):
    return np.random.RandomState(seed).rand(n, *HW, 3).astype(np.float32)


def _live(model, sd, x):
    model.load_state_dict(sd)
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


def _rel(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_reference():
    """name -> (x [6, H, W, 3], the JAX model's logits of x): one compile
    each. The TFLite tests take x[:1], the SavedModel tests x[:2] and x."""
    x = _inputs(6)
    out = {}
    for name in NAMES:
        jm, v, _ = family(name)
        out[name] = (x, np.asarray(jax.jit(lambda x: jm.apply(v, x, train=False))(x)))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_savedmodel_polymorphic_batch(tf, jax_reference, name, tmp_path):
    """At batch 2 and 6, against the JAX model, the port's live model and,
    for the unet, the JAX SavedModel (the flagship's jax2tf SavedModel takes
    ~30 s to write and run here; its TFLite artifact is held below)."""
    jm, v, pm = family(name)
    sd = state_dict_from_flax(v)
    path = str(tmp_path / "port")
    assert tf_export.export_savedmodel(pm, sd, *HW, path) == path
    x6, want6 = jax_reference[name]
    if name == "unet":
        jax_tf.export_savedmodel(jm, v, *HW, str(tmp_path / "jax"))
        assert _rel(tf_export.run_savedmodel(path, x6),
                    jax_tf.run_savedmodel(str(tmp_path / "jax"), x6)) <= FP32_RTOL
    for n in (2, 6):
        got = tf_export.run_savedmodel(path, x6[:n])
        assert _rel(got, want6[:n]) <= FP32_RTOL
        assert _rel(got, _live(pm, sd, x6[:n])) <= FP32_RTOL


@pytest.mark.parametrize("name,dtype", [("unet", "float32"), ("unet", "float16"),
                                        ("mobilenetv2_unet", "float32"),
                                        ("mobilenetv2_unet", "float16")])
def test_tflite(tf, jax_reference, name, dtype, tmp_path):
    """Against the JAX model, the port's live model and the JAX TFLite
    artifact of the same dtype (for the flagship, its fp16 one)."""
    jm, v, pm = family(name)
    sd = state_dict_from_flax(v)
    # batch -1 means 1 for TFLite, in both packages
    data = tf_export.export_tflite(pm, sd, *HW, str(tmp_path / "port.tflite"), batch=-1,
                                   dtype=dtype)
    assert open(tmp_path / "port.tflite", "rb").read() == data
    x = jax_reference[name][0][:1]
    got = tf_export.run_tflite(str(tmp_path / "port.tflite"), x)
    tol = FP32_RTOL if dtype == "float32" else FP16_RTOL
    assert _rel(got, jax_reference[name][1][:1]) <= tol
    assert _rel(got, _live(pm, sd, x)) <= tol
    if name == "unet" or dtype == "float16":
        want = jax_tf.export_tflite(jm, v, *HW, str(tmp_path / "jax.tflite"), batch=-1,
                                    dtype=dtype)
        assert _rel(got, jax_tf.run_tflite(want, x)) <= tol
    if dtype == "float16":
        # the conv weights are stored in fp16: well under their fp32 bytes
        fp32_bytes = 4 * sum(t.numel() for k, t in sd.items() if k.endswith(".weight"))
        assert len(data) < 0.75 * fp32_bytes, (len(data), fp32_bytes)


def test_bf16_compute_model_exports_its_fp32_function(tf, tmp_path):
    """The graph is the fp32 function of the weights whatever the model's
    compute dtype (ROADMAP.md C19): within 1e-4 of the fp32 live model, and
    of the bf16 one within C5's bf16 bound (2^-4 of the largest logit)."""
    _, v, pm = family("unet")
    sd = state_dict_from_flax(v)
    _, _, pm16 = family("unet", compute_dtype="bfloat16")
    path = str(tmp_path / "bf16")
    tf_export.export_savedmodel(pm16, sd, *HW, path)
    x = _inputs(2)
    got = tf_export.run_savedmodel(path, x)
    assert _rel(got, _live(pm, sd, x)) <= FP32_RTOL
    assert _rel(got, _live(pm16, sd, x)) <= 2 ** -4


def test_tflite_refuses_bf16(tf, tmp_path):
    _, v, pm = family("unet")
    with pytest.raises(ValueError, match="float16-only"):
        tf_export.export_tflite(pm, state_dict_from_flax(v), *HW, str(tmp_path / "m.tflite"),
                                dtype="bfloat16")


def test_without_tensorflow_convert_exits_1_naming_it(tmp_path, monkeypatch, capsys):
    from tpuseg_torch.convert import main

    _, v, _ = family("unet")
    pth = tmp_path / "unet.pth"
    torch.save(state_dict_from_flax(v), pth)
    monkeypatch.setitem(sys.modules, "tensorflow", None)   # import raises ImportError
    with pytest.raises(ImportError, match="TensorFlow"):
        tf_export.run_savedmodel(str(tmp_path), _inputs(1))
    for fmt in ("savedmodel", "tflite"):
        out = tmp_path / fmt
        rc = main(["--platform=cpu", "--model.name=unet", "--model.base_filters=8",
                   "--data.height=32", "--data.width=64", f"--export.checkpoint={pth}",
                   f"--export.output={out}", f"--export.format={fmt}"])
        text = capsys.readouterr().out
        assert rc == 1 and "TensorFlow" in text and "Export is valid" not in text, text
        assert not out.exists()
