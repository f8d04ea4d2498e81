"""The port's boundaries: imports, device choice, config parity and the
options that are not ported yet."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpuseg.configs import load_config as jax_load_config, to_dict as jax_to_dict
from tpuseg_torch.configs import ModelConfig, load_config, to_dict
from tpuseg_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_without_jax_tpuseg_or_cv2():
    """Every module of tpuseg_torch imports with jax, flax, tpuseg and cv2
    refused by a meta-path finder (and chip_smoke.py with them)."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        BANNED = {"jax", "jaxlib", "flax", "tpuseg", "cv2", "orbax", "optax"}

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BANNED:
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import tpuseg_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpuseg_torch.__path__, "tpuseg_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
        assert not leaked, leaked
        print(" ".join(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    walked = out.stdout.split("\n")[-2].split()
    assert len(walked) >= 15
    for name in ("ops.morphology", "ops.native_post", "infer.postprocess", "infer.video",
                 "inference", "tools.serve", "ops.native_loader", "data.class_stats",
                 "data.visualize", "tools.pack_dataset", "tools.class_stats", "ops._native"):
        assert "tpuseg_torch." + name in walked


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_predictor_needs_a_card_unless_asked_for_cpu(monkeypatch):
    from tpuseg_torch.infer.predictor import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg.model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg.model, device="cuda")
    pred = Predictor(cfg.model, input_hw=(32, 64), device="cpu")
    assert pred.device.type == "cpu"
    for bad in (np.zeros((1, 32, 64, 3), np.float32), np.zeros((32, 64, 3), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            pred(bad)


@pytest.mark.parametrize("argv", [
    [],
    ["--model.use_pallas=true", "--model.up_subpixel=false"],
    ["--model.width_mult=0.5", "--infer.upscale_on_host=false", "--mesh.data=4",
     "--train.steps_per_dispatch=8", "--train.class_weights=1,2,3",
     '--data.sources=[{"kind":"synthetic","num_samples":8,"weight":1.0}]'],
])
def test_config_to_dict_equals_jax(argv):
    assert to_dict(load_config(argv)) == jax_to_dict(jax_load_config(argv))


def test_config_file_drives_both_packages(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("model:\n  use_pallas: true\n  up_subpixel: false\n"
                    "infer:\n  batch_size: 4\n")
    argv = ["--config", str(path), "--model.num_classes=7"]
    assert to_dict(load_config(argv)) == jax_to_dict(jax_load_config(argv))
    with pytest.raises(KeyError):
        load_config(["--model.nope=1"])


@pytest.mark.parametrize("kwargs", [
    dict(artifact="model.stablehlo"),
], ids=["artifact"])
def test_unported_predictor_options_raise(kwargs):
    from tpuseg_torch.infer.predictor import Predictor

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Predictor(ModelConfig(), device="cpu", **kwargs)


def test_mesh_predictor_guards_match_jax():
    """Mesh serving runs (tests/test_torch_port_mesh.py); its guards raise
    as the JAX Predictor's do: use_pallas, an indivisible batch, an
    artifact. A mesh of one rank serves as no mesh."""
    from tpuseg.core.mesh import create_mesh as jax_create_mesh
    from tpuseg.infer.predictor import Predictor as JaxPredictor
    from tpuseg_torch.core.mesh import Mesh, create_mesh
    from tpuseg_torch.infer.predictor import Predictor

    two = Mesh(2, 1, 0, "gloo")
    for kw in (dict(model_cfg=ModelConfig(use_pallas=True)),
               dict(model_cfg=ModelConfig(), batch_size=3),
               dict(model_cfg=ModelConfig(), artifact="model.stablehlo")):
        with pytest.raises(ValueError) as want:
            JaxPredictor(mesh=jax_create_mesh(data=2), **kw)
        with pytest.raises(ValueError) as got:
            Predictor(mesh=two, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    assert Predictor(ModelConfig(width_mult=0.25), mesh=create_mesh(), device="cpu").mesh is None


def test_unported_checkpoints_models_and_paths_raise(tmp_path):
    from tpuseg_torch.core.weights import state_dict_from_flax
    from tpuseg_torch.infer.predictor import Predictor
    from tpuseg_torch.models.registry import build_model

    with pytest.raises(NotImplementedError, match="Orbax"):
        Predictor(ModelConfig(), checkpoint=str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        Predictor(ModelConfig(), checkpoint=str(tmp_path / "missing"), device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        state_dict_from_flax({"params": {}, "batch_stats": {}, "quant": {}})
    for name in ("mobilenetv2_unet", "unet", "light_unet", "mobilenetv2_fpn",
                 "mobilenetv2_deeplab"):
        with pytest.raises(NotImplementedError, match="bfloat16"):
            build_model(ModelConfig(name=name, compute_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="artifact"):
        Predictor(ModelConfig(name="unet"), artifact="model.stablehlo", device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        state_dict_from_flax({"params": {"inc": {}}, "batch_stats": {}, "quant": {}})
    with pytest.raises(KeyError, match="Unknown model"):
        build_model(ModelConfig(name="nope"))
    with pytest.raises(ValueError, match="multiples of 32"):
        Predictor(ModelConfig(), input_hw=(48, 64), device="cpu")


def test_kernel_wrappers_validate_and_route_cpu_tensors_to_plain():
    before = dict(kernels.launches)
    logits = torch.randn(1, 4, 6, 10)
    cls, col = kernels.argmax_colorize(logits, np.zeros((10, 3), np.uint8))
    assert cls.shape == (1, 4, 6) and col.dtype == torch.uint32
    assert kernels.upsample2x_argmax(logits).shape == (1, 8, 12)
    assert kernels.launches == before
    with pytest.raises(ValueError, match="palette"):
        kernels.argmax_colorize(logits, np.zeros((4, 3), np.uint8))
    with pytest.raises(ValueError, match="shape mismatch"):
        kernels.fused_upsample_concat_conv(
            torch.zeros(1, 4, 4, 2), torch.zeros(1, 2, 2, 3),
            torch.zeros(3, 3, 4, 5), torch.zeros(5))
    with pytest.raises(ValueError, match="different devices"):
        kernels.fused_upsample_concat_conv(
            torch.zeros(1, 4, 4, 2), torch.zeros(1, 2, 2, 3),
            torch.zeros(3, 3, 5, 5), torch.zeros(5, device="meta"))
