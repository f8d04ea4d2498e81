"""The pretrained-encoder start in the port (tpuseg_torch/core/torch_import.py,
``python -m tpuseg_torch.tools.import_pretrained``) against the JAX
package's (tpuseg/core/torch_import.py, tools/import_pretrained.py).

A torchvision-named ``mobilenet_v2`` state_dict is synthesized from a seed
(tests/torch_ref.py's encoder, ``features.N.*`` with ``classifier.1.*``;
no download): the port's encoder import equals, bit for bit, JAX's
``import_torchvision_encoder`` + ``merge_variables`` mapped by
``state_dict_from_flax``, with both prefixes; a full reference state_dict
(the flagship, with its duplicate ``downK`` slices, and the UNet) equals
JAX's ``import_state_dict``; the overlay and importer errors carry JAX's
messages. The tool end to end: both flavours, the decoder left at the
port's seeded init, and its output loaded by the Trainer's
``init_checkpoint``, the Predictor, ``distill_checkpoint`` and
``eval_miou``. The random-init warning of ``tpuseg_torch.main`` names the
converter (ROADMAP.md C14).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_ref import TorchMobileNetV2UNet, TorchUNet
from tpuseg.core import torch_import as jti
from tpuseg.models.mobilenetv2_unet import MobileNetV2UNet as FlaxUNet
from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core import torch_import as pti
from tpuseg_torch.core.weights import state_dict_from_flax
from tpuseg_torch.infer.predictor import load_variables
from tpuseg_torch.models.registry import build_model
from tpuseg_torch.tools import import_pretrained


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _seeded(module, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for t in module.state_dict().values():
            if t.is_floating_point():
                t.uniform_(-0.1, 0.1)
    return module


def _torchvision_sd(prefix="features"):
    """A torchvision-named mobilenet_v2 state_dict (tensors), classifier
    included."""
    tm = _seeded(TorchMobileNetV2UNet(output_channels=10), 3)
    sd = {prefix + k[len("backbone.features"):]: v.clone()
          for k, v in tm.state_dict().items() if k.startswith("backbone.features.")}
    sd["classifier.1.weight"] = torch.zeros(1000, 1280)
    sd["classifier.1.bias"] = torch.zeros(1000)
    return sd


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_equal(got, want, keys):
    for k in keys:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("prefix", ["features", "backbone.features"])
def test_encoder_import_merged_equals_jax(prefix):
    sd = _torchvision_sd(prefix)
    enc = pti.import_torchvision_encoder(sd)
    j_enc = jti.import_torchvision_encoder(_np(sd))
    assert set(j_enc["params"]) == {"backbone"}
    # the encoder's entries: JAX's tree alone maps onto exactly them
    want_enc = state_dict_from_flax(j_enc)
    want_enc = {k: v for k, v in want_enc.items() if not k.endswith("num_batches_tracked")}
    assert set(enc) == set(want_enc)
    _assert_equal(enc, want_enc, enc)
    # merged over a base: JAX's over a zero tree of the flax model's shapes,
    # the port's over its seeded init
    shapes = jax.eval_shape(lambda: FlaxUNet(output_channels=10).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    merged = {c: jti.merge_variables(zeros[c], j_enc[c]) for c in ("params", "batch_stats")}
    want = state_dict_from_flax(merged)
    base = build_model(ModelConfig()).state_dict()
    got = pti.merge_variables(base, enc)
    assert set(got) == set(want) == set(base)
    _assert_equal(got, want, [k for k in got if k.startswith("backbone.")
                              and not k.endswith("num_batches_tracked")])
    _assert_equal(got, base, [k for k in got if not k.startswith("backbone.")])


@pytest.mark.parametrize("name", ["mobilenetv2_unet", "unet"])
def test_full_reference_import_equals_jax(name):
    if name == "unet":
        ref, cfg = TorchUNet(output_channels=10, base_filters=4), dict(base_filters=4)
    else:
        ref, cfg = TorchMobileNetV2UNet(output_channels=10), {}
    sd = _seeded(ref, 4).state_dict()
    base = build_model(ModelConfig(name=name, **cfg)).state_dict()
    got = pti.import_state_dict(sd, name, base)
    want = state_dict_from_flax(jti.import_state_dict(_np(sd), name))
    assert set(got) == set(want) == set(base)
    _assert_equal(got, want, [k for k in got if not k.endswith("num_batches_tracked")])
    if name == "mobilenetv2_unet":
        assert not any(k.startswith("down") for k in got) and any(k.startswith("down1.")
                                                                 for k in sd)


def test_overlay_and_importer_errors_match_jax():
    base = {"a": torch.zeros(2, 2), "b": torch.zeros(3)}
    for overlay, err in (({"nope": torch.zeros(1)}, KeyError),
                         ({"a": torch.zeros(3, 3)}, ValueError)):
        with pytest.raises(err) as want:
            jti.merge_variables(_np(base), _np(overlay))
        with pytest.raises(err) as got:
            pti.merge_variables(base, overlay)
        assert str(got.value) == str(want.value)
    with pytest.raises(KeyError, match="no importer for model 'mobilenetv2_fpn'"):
        pti.import_state_dict({}, "mobilenetv2_fpn", {})
    target = build_model(ModelConfig(name="unet", base_filters=4)).state_dict()
    with pytest.raises(KeyError, match="does not look like a 'unet' checkpoint"):
        pti.import_state_dict(_torchvision_sd(), "unet", target)
    with pytest.raises(KeyError, match="does not look like a 'unet' checkpoint"):
        jti.import_state_dict(_np(_torchvision_sd()), "unet")


def test_import_pretrained_tool_end_to_end(tmp_path, capsys):
    from tpuseg_torch.configs import load_config
    from tpuseg_torch.infer.predictor import Predictor
    from tpuseg_torch.tools import eval_miou
    from tpuseg_torch.train.trainer import Trainer

    sd = _torchvision_sd()
    pth = tmp_path / "mobilenet_v2.pth"
    torch.save(sd, str(pth))
    out = tmp_path / "ckpt"
    assert import_pretrained.main(["--pth", str(pth), "--out", str(out)]) == 0
    assert "encoder-only" in capsys.readouterr().out
    assert sorted(p.name for p in out.iterdir()) == ["step_0.pt"]
    got = load_variables(str(out), lambda: None)
    seeded = build_model(ModelConfig()).state_dict()
    for k, v in got.items():
        if k.startswith("backbone.features.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k[len("backbone."):]]), k
        else:
            assert torch.equal(v, seeded[k]), k
    flags = ["--data.height=32", "--data.width=64", "--train.batch_size=2",
             "--train.checkpoint_dir=",
             '--data.sources=[{"kind":"synthetic","num_samples":4,"weight":1.0}]']
    tr = Trainer(load_config([*flags, f"--train.init_checkpoint={out}",
                              f"--train.distill_checkpoint={out}"]), device="cpu")
    assert all(torch.equal(v, got[k]) for k, v in tr.model.state_dict().items())
    assert all(torch.equal(v, got[k]) for k, v in tr.teacher.state_dict().items())
    pred = Predictor(ModelConfig(), checkpoint=str(out), input_hw=(32, 64), device="cpu")
    assert pred(np.zeros((2, 40, 70, 3), np.uint8)).shape == (2, 40, 70)
    assert eval_miou.main(["--kind", "synthetic", "--samples", "2", "--batch", "2",
                           "--width", "64", "--height", "32", "--checkpoint", str(out),
                           "--platform", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["n_images"] == 2

    # a full reference state_dict imports everything; encoder-only needs the flagship
    full = tmp_path / "full.pth"
    ref = _seeded(TorchMobileNetV2UNet(output_channels=10), 5).state_dict()
    torch.save(ref, str(full))
    assert import_pretrained.main(["--pth", str(full), "--out", str(tmp_path / "f")]) == 0
    got = load_variables(str(tmp_path / "f"), lambda: None)
    assert all(torch.equal(v, ref[k]) for k, v in got.items())
    assert import_pretrained.main(["--pth", str(pth), "--out", str(tmp_path / "u"),
                                   "--model", "unet"]) == 1


def test_random_init_warning_names_the_converter(monkeypatch, capsys):
    """ROADMAP.md C14: as the JAX main.py names tools/import_pretrained.py,
    the port's names its own converter."""
    import tpuseg_torch.train.trainer as trainer_mod
    from tpuseg_torch.main import main

    class Stub:
        def __init__(self, cfg, device=None):
            pass

        def train(self):
            return []

    monkeypatch.setattr(trainer_mod, "Trainer", Stub)
    main(["--platform=cpu", "--train.checkpoint_dir="])
    out = capsys.readouterr().out
    assert "RANDOM init" in out
    assert "python -m tpuseg_torch.tools.import_pretrained --pth mobilenet_v2.pth" in out
    assert "--train.init_checkpoint=pretrained/mnv2" in out
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "main.py")) as f:
        assert "tools/import_pretrained.py --pth mobilenet_v2.pth" in f.read()
