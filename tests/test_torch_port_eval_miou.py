"""``python -m tpuseg_torch.tools.eval_miou`` against the JAX package's
tools/eval_miou.py.

One synthetic set (``--kind synthetic``, 12 scenes at 32x16; the port's
SyntheticSource is bit-equal to the JAX one) and one tiny UNet checkpoint
(base_filters 4): the JAX tool reads it as Orbax, the port's tool its
conversion by tools/orbax_to_torch.py. Whole set, ``--limit`` and
``--holdout_val_split``: ``n_images`` equal, ``miou`` and ``pixel_acc``
within 1e-4 (float32 forwards summed in other orders may flip a pixel
near a tie; none flips here). A checkpoint carrying a ``quant`` tree is
refused with exit code 1, as the JAX tool refuses one.
"""

import json

import pytest
import torch

from tests.test_torch_port_orbax import BF, flax_variables, jax_tool, save_orbax
from tpuseg_torch.core.checkpoint import CheckpointManager
from tpuseg_torch.tools import eval_miou

SET = ["--kind", "synthetic", "--samples", "12", "--width", "32", "--height", "16",
       "--model", "unet", "--base_filters", str(BF), "--batch", "4", "--platform", "cpu"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_miou")
    orbax = save_orbax(root / "orbax", 5, flax_variables(3))
    jax_tool("orbax_to_torch").convert(orbax, str(root / "torch"))
    return orbax, str(root / "torch")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [[], ["--limit", "5"], ["--holdout_val_split", "0.5"]],
                         ids=["all", "limit", "holdout"])
def test_port_tool_equals_the_jax_tool(checkpoints, capsys, extra):
    orbax, converted = checkpoints
    assert jax_tool("eval_miou").main([*SET, *extra, "--checkpoint", orbax]) == 0
    want = _last_json(capsys)
    assert eval_miou.main([*SET, *extra, "--checkpoint", converted]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want)
    assert got["n_images"] == want["n_images"] == {"all": 12, "limit": 5,
                                                   "holdout": 6}[_id(extra)]
    for k in ("miou", "pixel_acc"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-4)
    assert [v is None for v in got["iou_per_class"]] == \
        [v is None for v in want["iou_per_class"]]


def _id(extra):
    return "limit" if "--limit" in extra else "holdout" if extra else "all"


def test_quant_checkpoint_and_bad_flags_refused(checkpoints, tmp_path, capsys):
    _, converted = checkpoints
    payload = torch.load(f"{converted}/step_5.pt", weights_only=True)
    CheckpointManager(str(tmp_path / "q")).save(5, {**payload, "quant": {"s": torch.ones(1)}})
    assert eval_miou.main([*SET, "--checkpoint", str(tmp_path / "q")]) == 1
    assert "calibrated 'quant' collection" in capsys.readouterr().err
    assert eval_miou.main([*SET, "--limit", "3", "--holdout_val_split", "0.5"]) == 1
    assert eval_miou.main([*SET[:-2], "--platform", "cpu", "--kind", "bdd100k",
                           "--data_dir", str(tmp_path / "none")]) == 1
