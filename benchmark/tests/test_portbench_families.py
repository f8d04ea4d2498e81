"""A model family given as a file of its own: ``reference.models.build``
finds ``reference/families/<family>.py`` under the run's root, the seeded
weights draw its linear layers He-normal, and the bfloat16 reference
rounds its linear layers, LayerNorms and GELUs.

The two families of ``reference/models.py`` must read exactly as they did
before families could be files: their seeded states, the FLOPs of each
cell and their bfloat16 logits are pinned below, as digests taken before
that change.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark import counts, harness, run, scenes
from benchmark.reference import models
from benchmark.reference.lowp import rounding
from benchmark.reference.steps import plain_float32
from benchmark.tests.conftest import write_toy_root
from benchmark.weights import seeded_state

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2 ** 31 + 2021
# blake2b-128 of each configuration's seeded state (CPU generator, stream 1
# of SEED) and of its bfloat16 logits on a seeded [2, 3, 64, 64] input, in
# eval, on one CPU thread (the CPU's convolutions sum in another order on
# more threads)
PINNED = {
    "mnv2-unet": {"state": "4f24dc4ea5546c66c51cf33649357f41",
                  "logits": "989c17c1745db40c9b1e7ee4483b462b"},
    "mnv2-deeplab-c66": {"state": "18372bf4c3e044ee9be9eb6ccc42ed74",
                         "logits": "60805c7e98a71804a398b1577158db79"},
}
# the seeded states drawn on the card (an H100's generator, stream 1 of
# CARD_SEED), as the parent of this check drew them there
CARD_SEED = 2200000001
CARD_PINNED = {"mnv2-unet": "f9d322a587b9ede53ab9dd5ac2d00794",
               "mnv2-deeplab-c66": "39483847c8ffebdae249cbebbae70f28"}
# counts.model_flops of each cell at its shapes
PINNED_FLOPS = {
    "unet-train-b64": ("mnv2-unet", 64, 128, 256, True, 551947862016),
    "deeplab-train-c66": ("mnv2-deeplab-c66", 32, 256, 512, True, 2500158554112),
    "unet-serve-720p-b16": ("mnv2-unet", 16, 512, 1024, False, 735930482688),
}
TOY_ARCH = {"family": "toy_transformer", "num_classes": 5, "dim": 32, "heads": 2, "depth": 2}


def digest(tensors) -> str:
    h = hashlib.blake2b(digest_size=16)
    for key, t in tensors.items():
        h.update(key.encode())
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def arch_of(config: str) -> dict:
    return harness.load_json(harness.find(harness.CHECKOUT, "configs", config, ".json"))["reference"]


def seeded(arch: dict, root: str = harness.CHECKOUT):
    """The reference of ``arch`` on the CPU with the seeded state loaded."""
    with torch.device("meta"):
        model = models.build(arch, root)
    state = seeded_state(model, scenes.generator(SEED, 1, "cpu"), "cpu")
    model = model.to_empty(device="cpu")
    model.load_state_dict(state)
    return model, state


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def family_root(tmp_path):
    """A tree whose ``benchmark/reference/families`` holds the toy families."""
    families = tmp_path / "benchmark" / "reference" / "families"
    families.mkdir(parents=True)
    shutil.copy(os.path.join(HERE, "toy_families", "toy_transformer.py"), families)
    (families / "toy_unet_copy.py").write_text(
        "from benchmark.reference.models import MobileNetV2UNet\n\n\n"
        "def build(arch):\n"
        "    return MobileNetV2UNet(arch[\"num_classes\"])\n")
    return str(tmp_path)


@pytest.mark.parametrize("config", sorted(PINNED))
def test_seeded_state_and_bf16_logits_are_pinned(config, one_thread):
    model, state = seeded(arch_of(config))
    x = torch.randn(2, 3, 64, 64, generator=scenes.generator(SEED, 2, "cpu"))
    with torch.no_grad(), plain_float32(), rounding(model, "bfloat16"):
        logits = model.eval()(x)
    assert {"state": digest(state), "logits": digest({"logits": logits})} == PINNED[config]


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CARD_PINNED))
def test_card_seeded_state_is_pinned(card, config):
    with torch.device("meta"):
        model = models.build(arch_of(config))
    state = seeded_state(model, scenes.generator(CARD_SEED, 1, card), card)
    assert digest(state) == CARD_PINNED[config]


@pytest.mark.parametrize("cell", sorted(PINNED_FLOPS))
def test_cell_flops_are_pinned(cell):
    config, batch, height, width, train, flops = PINNED_FLOPS[cell]
    assert counts.model_flops(arch_of(config), batch, height, width, train) == flops


def test_unknown_family_names_both_places(tmp_path):
    with pytest.raises(KeyError) as err:
        models.build({"family": "no_such_family"}, str(tmp_path))
    text = str(err.value)
    assert "'no_such_family'" in text
    assert os.path.join(str(tmp_path), "benchmark", "reference", "families",
                        "no_such_family.py") in text
    assert os.path.join(harness.PACKAGE, "reference", "families", "no_such_family.py") in text


def test_toy_transformer_weights(family_root):
    model, state = seeded({**TOY_ARCH, "dim": 256}, family_root)
    linears = [k for k, v in state.items() if k.endswith(".weight") and v.dim() == 2]
    assert len(linears) == 2 * 5 + 1
    for key in linears:
        w = state[key]
        var = 2.0 / w.shape[1]
        # the sample variance of n normal draws has relative spread sqrt(2 / n)
        assert abs(w.var().item() / var - 1.0) < 6 * math.sqrt(2.0 / w.numel()), key
        assert abs(w.mean().item()) < 6 * math.sqrt(var / w.numel()), key
    for key in (k for k in state if k.endswith("norm.weight") or k.endswith(".gamma")):
        assert 0.5 <= state[key].min() and state[key].max() <= 1.5, key
    assert state["embed.weight"].var().item() == pytest.approx(2.0 / 48, rel=0.2)


def test_a_leaf_without_a_rule_raises(family_root, monkeypatch):
    with torch.device("meta"):
        model = models.build(TOY_ARCH, family_root)
    monkeypatch.setattr(type(model), "SEEDED_RULES", {})
    with pytest.raises(KeyError, match="gamma"):
        seeded_state(model, scenes.generator(SEED, 1, "cpu"), "cpu")


def _r(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _linear(m, x):
    return _r(_r(F.linear(_r(x), _r(m.weight))) + _r(m.bias))


def _layer_norm(m, x):
    return _r(F.layer_norm(x, m.normalized_shape, m.weight, m.bias, m.eps))


def _hand_rounded(model, x):
    """The toy transformer's forward with every bfloat16 rounding written out."""
    b, _, h, w = x.shape
    e = model.embed
    y = _r(_r(F.conv2d(_r(x), _r(e.weight), None, e.stride)) + _r(e.bias).view(-1, 1, 1))
    y = _layer_norm(model.embed_norm, y.flatten(2).transpose(1, 2))
    for res in model.blocks:
        n = _layer_norm(res.norm, y)
        if hasattr(res.fn, "core"):
            a = res.fn
            k, v = _linear(a.kv, n).chunk(2, dim=-1)
            out = _linear(a.proj, _r(a.core(_linear(a.q, n), k, v)))
        else:
            fc1, _, fc2 = res.fn
            out = _linear(fc2, _r(F.gelu(_linear(fc1, n))))
        y = _r(y + res.gamma * out)
    y = _linear(model.head, _layer_norm(model.norm, y))
    y = y.transpose(1, 2).reshape(b, -1, h // 4, w // 4)
    return F.interpolate(y, scale_factor=4, mode="bilinear", align_corners=False)


def test_toy_transformer_bf16_forward_is_hand_rounded(family_root, one_thread):
    model, _ = seeded(TOY_ARCH, family_root)
    model.eval()
    x = torch.randn(2, 3, 16, 32, generator=scenes.generator(SEED, 2, "cpu"))
    with torch.no_grad():
        plain = model(x)
        with rounding(model, "bfloat16"):
            rounded = model(x)
        hand = _hand_rounded(model, x)
        after = model(x)
    assert torch.equal(rounded, hand)
    assert not torch.equal(rounded, plain)
    assert torch.equal(after, plain)          # the rounding is gone after the block


def test_toy_transformer_rounds_each_output(family_root):
    model, _ = seeded(TOY_ARCH, family_root)
    kinds = (nn.Linear, nn.LayerNorm, nn.GELU) + type(model).ROUNDED_OUTPUTS
    seen = []
    x = torch.randn(2, 3, 16, 32, generator=scenes.generator(SEED, 2, "cpu"))
    with torch.no_grad(), rounding(model, "bfloat16"):
        hooks = [m.register_forward_hook(lambda mod, args, out: seen.append((mod, out)))
                 for m in model.modules() if isinstance(m, kinds)]
        model.eval()(x)
        for h in hooks:
            h.remove()
    depth = TOY_ARCH["depth"]
    # every one of them ran: a block's five linear layers, two LayerNorms,
    # GELU, attention core and two residuals; the embedding's LayerNorm, the
    # last one and the classifier
    assert len(seen) == depth * (5 + 2 + 1 + 1 + 2) + 3
    for mod, out in seen:
        assert torch.equal(out, _r(out)), type(mod).__name__


def test_toy_transformer_flops_count_its_matmuls(family_root):
    a = TOY_ARCH
    b, h, w = 2, 16, 32
    n, c = (h // 4) * (w // 4), a["dim"]
    per_block = 2 * b * n * c * (c + 2 * c + c + 4 * c + 4 * c) + 2 * 2 * b * n * n * c
    hand = 2 * b * n * c * 3 * 16 + a["depth"] * per_block + 2 * b * n * c * a["num_classes"]
    assert counts.model_flops(a, b, h, w, train=False, root=family_root) == hand
    assert counts.model_flops(a, b, h, w, train=True, root=family_root) == 3 * hand


def _family_cells(root: str) -> None:
    """The toy flagship cells again, as ``copy-train`` and ``copy-serve``,
    their configuration's reference the ``toy_unet_copy`` family of
    ``root``'s files. A serving pair's pool is one batch, so that every
    call the reservoir keeps serves the same frames in both cells."""
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    config = harness.load_json(harness.find(root, "configs", "mnv2-unet", ".json"))
    config.update(name="toy-unet-copy", reference={**config["reference"],
                                                   "family": "toy_unet_copy"})
    with open(os.path.join(root, "benchmark", "configs", "toy-unet-copy.json"), "w") as f:
        json.dump(config, f)
    bench["configs"].append({"name": "toy-unet-copy", "source": "a test",
                             "file": "benchmark/configs/toy-unet-copy.json", "reduced": [],
                             "why": "a family from a file"})
    cells = {"copy-train": "unet-train-b64", "copy-serve": "unet-serve-720p-b16"}
    for cell, like in cells.items():
        spec = harness.load_json(harness.find(root, "workloads", like, ".json"))
        if "pool_batches" in spec["traffic"]:
            spec["traffic"]["pool_batches"] = 1
        for name in (like, cell):
            with open(os.path.join(root, "benchmark", "workloads", name + ".json"), "w") as f:
                json.dump({**spec, "name": name, **({"config": "toy-unet-copy"}
                                                    if name == cell else {})}, f)
        bench["workloads"].append({"name": cell, "config": "toy-unet-copy", "traffic": cell,
                                   "chips": 1, "why": "a family from a file"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.mark.parametrize("cell,like,dtype,trace", [
    ("copy-train", "unet-train-b64", "float32", 1),
    ("copy-serve", "unet-serve-720p-b16", "bfloat16", 0)])
def test_a_family_from_a_file_runs_correct(family_root, cell, like, dtype, trace, two_threads):
    # training computes in float32 as the sound runs of test_portbench_faults
    # do: at the toy size the bfloat16 program's gradients read 0.498 from
    # the float32 reference's by grad_rms_gap_median, the built-in family's
    # too, against a limit set at the cell's own size
    root = write_toy_root(family_root, compute_dtype=dtype)
    _family_cells(root)

    def toy_run(name, trace=0):
        return run.main(["--workload", name, "--seed", str(SEED), "--seconds", "0.5",
                         "--trace", str(trace)], device="cpu", root=root)

    line = toy_run(cell, trace)
    assert line["correct"] and line["attempted"] > 0 and line["failed"] == 0
    # the same numbers as the cell whose family reference/models.py holds
    assert line["checks"] == toy_run(like)["checks"]
    if trace:
        # the MFU reader counts the family's FLOPs through the run's root
        assert line["metrics"]["mfu.train"]["value"] > 0
