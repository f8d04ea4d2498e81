"""Orbax checkpoints of the JAX package into the port (tools/orbax_to_torch.py).

The JAX ``CheckpointManager`` saves a tiny UNet's (base_filters 4)
``{"state": {"params", "batch_stats"[, "ema_params"]}}`` from its init,
with no JAX training, as the JAX Trainer lays a checkpoint out. The
converter writes the port's checkpoint directory at the same step; the
port's eval forward of it equals flax's ``model.apply(train=False)`` within
rtol 1e-5 (atol 1e-6; float32 convs summed in another order); the EMA
parameters are taken when the checkpoint has them, as the JAX Predictor
serves them; a calibrated int8 ``quant`` tree (the JAX ``calibrate``)
is converted onto the port's conv names, equal to ``quant_from_flax``, and
served in int8; and the port, given the Orbax directory itself, raises
naming the converter.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.core.checkpoint import CheckpointManager
from tpuseg.models.unet import UNet as FlaxUNet
from tpuseg_torch.configs import ModelConfig
from tpuseg.export.int8_full import calibrate as jax_calibrate
from tpuseg_torch.core.weights import quant_from_flax, state_dict_from_flax
from tpuseg_torch.infer.predictor import Predictor, load_variables
from tpuseg_torch.models.registry import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF, HW = 4, (16, 32)


def jax_tool(name: str):
    """tools/<name>.py of the repo, imported fresh."""
    spec = importlib.util.spec_from_file_location(f"{name}_under_test",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(spec.name, None)
    return mod


def flax_variables(seed: int) -> dict:
    """The tiny UNet's init, its BatchNorm statistics seeded away from 0/1."""
    v = FlaxUNet(output_channels=10, base_filters=BF).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, *HW, 3)), train=False)
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32), v["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]), "batch_stats": stats}


def save_orbax(directory, step: int, state: dict) -> str:
    with CheckpointManager(str(directory), async_save=False) as mgr:
        mgr.save(step, {"state": state}, force=True)
    return str(directory)


@pytest.fixture(scope="module")
def orbax_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax")
    v, ema = flax_variables(0), flax_variables(1)
    quant = jax_calibrate(FlaxUNet(output_channels=10, base_filters=BF), v,
                          [jnp.asarray(np.random.RandomState(3).randn(2, *HW, 3), jnp.float32)])
    return {"plain": (save_orbax(root / "plain", 7, v), v),
            "ema": (save_orbax(root / "ema", 3, {**v, "ema_params": ema["params"]}),
                    {"params": ema["params"], "batch_stats": v["batch_stats"]}),
            "quant": (save_orbax(root / "quant", 1, {**v, "quant": quant}),
                      {**v, "quant": quant})}


@pytest.mark.parametrize("case", ["plain", "ema"])
def test_converted_forward_equals_flax(orbax_dirs, tmp_path, capsys, case):
    src, want_vars = orbax_dirs[case]
    out = tmp_path / "torch"
    assert jax_tool("orbax_to_torch").main(["--checkpoint", src, "--out", str(out),
                                            "--platform", "cpu"]) == 0
    step = 7 if case == "plain" else 3
    assert sorted(p.name for p in out.iterdir()) == [f"step_{step}.pt"]
    assert f"step {step}" in capsys.readouterr().out
    payload = torch.load(out / f"step_{step}.pt", weights_only=True)
    assert payload["step"] == step
    sd = load_variables(str(out), lambda: None)
    want_sd = state_dict_from_flax(want_vars)
    assert set(sd) == set(want_sd) and all(torch.equal(sd[k], want_sd[k]) for k in sd)
    model = build_model(ModelConfig(name="unet", base_filters=BF))
    model.load_state_dict(sd, strict=True)
    x = np.random.RandomState(2).rand(2, *HW, 3).astype(np.float32)
    want = np.asarray(FlaxUNet(output_channels=10, base_filters=BF).apply(
        want_vars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_quant_tree_refused_and_orbax_dir_names_the_converter(orbax_dirs, tmp_path):
    """A calibrated int8 checkpoint is no longer refused: its quant tree is
    converted beside the weights and the port serves it in int8."""
    convert = jax_tool("orbax_to_torch").convert
    src, want_vars = orbax_dirs["quant"]
    out = tmp_path / "q"
    assert convert(src, str(out)) == 1
    payload = torch.load(out / "step_1.pt", weights_only=True)
    want = quant_from_flax(want_vars)
    assert len(want) == 15 and set(payload["quant"]) == set(want)
    for name, q in want.items():
        assert set(payload["quant"][name]) == set(q)
        assert all(torch.equal(payload["quant"][name][k], t) for k, t in q.items())
    p = Predictor(ModelConfig(name="unet", base_filters=BF), input_hw=HW, checkpoint=str(out),
                  device="cpu")
    assert p.int8
    with pytest.raises(NotImplementedError, match="python tools/orbax_to_torch.py "
                                                  "--checkpoint .* --out"):
        Predictor(ModelConfig(name="unet", base_filters=BF), input_hw=HW,
                  checkpoint=orbax_dirs["plain"][0], device="cpu")
