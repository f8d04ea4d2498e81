"""The port's file-backed data layer against the JAX package's, on the CPU.

Tiny datasets are written here with cv2 from a seed (as tests/test_data.py
writes its own), nothing is downloaded. Held equal to the JAX package:
the class maps and LUTs; the BDD100K, CARLA and SEAME sources byte for
byte on the same files (odd source sizes, so both resizes run; ``_viz``
masks, a count mismatch paired by stem, an unreadable file); the packer
(``tpuseg_torch.tools.pack_dataset`` writes the files of
``tools/pack_dataset.py``, a skipped tail included) and the packed source,
whose batch gather gives the same bytes natively and with numpy; the input
pipeline's batches from a packed source; ``class_stats`` and the Trainers'
``class_weights=auto``; the visualize helpers. Without cv2 the directory
sources raise naming the packed route.
"""

import importlib.util
import json
import logging
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from tpuseg.configs import DatasetSourceConfig as JaxSourceConfig
from tpuseg.data import class_maps as jcm
from tpuseg.data import class_stats as jstats
from tpuseg.data import visualize as jvis
from tpuseg.data.combined import CombinedDataset as JaxCombined
from tpuseg.data.pipeline import InputPipeline as JaxPipeline
from tpuseg.data.sources import PackedSource as JaxPacked
from tpuseg.data.sources import build_source as jax_build_source
from tpuseg_torch.configs import DatasetSourceConfig, load_config
from tpuseg_torch.data import class_maps as cm
from tpuseg_torch.data import class_stats as stats
from tpuseg_torch.data import visualize as vis
from tpuseg_torch.data.combined import CombinedDataset
from tpuseg_torch.data.pipeline import InputPipeline
from tpuseg_torch.data.sources import PackedSource, SyntheticSource, build_source
from tpuseg_torch.ops import native_loader
from tpuseg_torch.tools import class_stats as class_stats_tool
from tpuseg_torch.tools import pack_dataset
from tpuseg_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 24, 16          # the model size: every source image is resized to it


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"{name}_jax_tool",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(kind, width=W, height=H, **kw):
    return (build_source(DatasetSourceConfig(kind=kind, **kw), width, height),
            jax_build_source(JaxSourceConfig(kind=kind, **kw), width, height))


def _assert_same_samples(port, ref):
    assert len(port) == len(ref)
    for i in range(len(ref)):
        a, b = port.load(i), ref.load(i)
        if b is None:
            assert a is None
            continue
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.uint8
            np.testing.assert_array_equal(x, y)


# -- class maps ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["CLASS_NAMES", "NUM_CLASSES", "BDD100K_CLASS_MAP",
                                  "CARLA_CLASS_MAP", "SEAME_CLASS_MAP", "BDD100K_LUT",
                                  "CARLA_LUT", "COLOR_MAP_BGR", "COLOR_MAP_RGB"])
def test_class_maps_equal_jax(name):
    a, b = getattr(cm, name), getattr(jcm, name)
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_build_lut_equals_jax():
    rng = np.random.RandomState(0)
    cmap = {int(k): int(v) for k, v in zip(rng.choice(256, 30, replace=False),
                                           rng.randint(0, 10, 30))}
    np.testing.assert_array_equal(cm.build_lut(cmap), jcm.build_lut(cmap))
    np.testing.assert_array_equal(cm.build_lut(cmap, 64 + 256), jcm.build_lut(cmap, 64 + 256))


# -- directory trees -------------------------------------------------------------


def _write_pair(img_dir, mask_dir, stem, rng, img_ext=".jpg", hw=(37, 53)):
    cv2.imwrite(str(img_dir / f"{stem}{img_ext}"), rng.randint(0, 255, (*hw, 3), np.uint8))
    cv2.imwrite(str(mask_dir / f"{stem}.png"), rng.randint(0, 26, hw, np.uint8))


def _tree(root, kind, unreadable="c003", extra_image=True):
    """A BDD100K or CARLA tree at odd sizes (37x53, one 16x24 pair at the
    model size): one image without a mask (paired by stem), one corrupt
    image whose mask exists; CARLA's mask dir also holds *_viz.png."""
    img_dir, mask_dir = root / f"{kind}_images", root / f"{kind}_masks"
    img_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.RandomState(1)
    ext = ".png" if kind == "carla" else ".jpg"
    for i in range(4):
        _write_pair(img_dir, mask_dir, f"c{i:03d}", rng, ext, (H, W) if i == 1 else (37, 53))
    if kind == "bdd100k":
        _write_pair(img_dir, mask_dir, "d000", rng, ".png")
    if kind == "carla":
        cv2.imwrite(str(mask_dir / "c000_viz.png"), rng.randint(0, 255, (37, 53, 3), np.uint8))
        (img_dir / "notes.txt").write_text("not an image")
    if extra_image:
        cv2.imwrite(str(img_dir / f"z_nomask{ext}"), rng.randint(0, 255, (20, 30, 3), np.uint8))
    if unreadable:
        (img_dir / f"{unreadable}{ext}").write_bytes(b"not an image at all")
        if not (mask_dir / f"{unreadable}.png").exists():
            cv2.imwrite(str(mask_dir / f"{unreadable}.png"), rng.randint(0, 26, (9, 9), np.uint8))
    return str(img_dir), str(mask_dir)


@pytest.mark.parametrize("kind", ["bdd100k", "carla"])
def test_directory_source_is_bit_equal_to_jax(tmp_path, kind):
    img_dir, mask_dir = _tree(tmp_path, kind)
    port, ref = _both(kind, img_dir=img_dir, mask_dir=mask_dir)
    assert port.images == ref.images and port.masks == ref.masks
    assert not any("z_nomask" in p for p in port.images)       # paired by stem
    assert not any(p.endswith("_viz.png") for p in port.masks)
    _assert_same_samples(port, ref)
    assert port.load(port.images.index(os.path.join(img_dir, "c003" + (
        ".png" if kind == "carla" else ".jpg")))) is None       # unreadable: skipped
    image, mask = port.load(0)
    assert image.shape == (H, W, 3) and mask.shape == (H, W) and mask.max() <= 9


@pytest.mark.parametrize("kind", ["bdd100k", "carla"])
def test_directory_source_without_matching_stems_raises(tmp_path, kind):
    img_dir, mask_dir = tmp_path / "i", tmp_path / "m"
    img_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.RandomState(2)
    for stem in ("a", "b"):
        cv2.imwrite(str(img_dir / f"{stem}.png"), rng.randint(0, 255, (8, 8, 3), np.uint8))
    cv2.imwrite(str(mask_dir / "q.png"), rng.randint(0, 9, (8, 8), np.uint8))
    for build, cfg in ((build_source, DatasetSourceConfig), (jax_build_source, JaxSourceConfig)):
        with pytest.raises(FileNotFoundError, match="no filename stems"):
            build(cfg(kind=kind, img_dir=str(img_dir), mask_dir=str(mask_dir)), W, H)


def _seame_tree(root):
    rng = np.random.RandomState(3)
    (root / "frames").mkdir()
    lines = []
    for name, hw in (("a.jpg", (40, 70)), ("b.png", (33, 51))):
        cv2.imwrite(str(root / "frames" / name), rng.randint(0, 255, (*hw, 3), np.uint8))
    lines.append({"raw_file": "frames/a.jpg", "image_height": 40, "image_width": 70,
                  "annotations": [
                      {"type": "drivable_area", "polygons": [[[5, 35], [66, 35], [40, 10]]]},
                      {"type": "car", "polygons": [[[0, 0], [10, 0], [10, 10], [0, 10]],
                                                   [[50, 20], [60, 22], [55, 30]]]},
                      {"type": "unknown_thing", "polygons": [[[0, 0], [5, 0], [5, 5]]]}]})
    lines.append({"raw_file": "frames/b.png", "image_height": 33, "image_width": 51,
                  "polygons": [[[0, 32], [50, 32], [25, 15]]]})
    lines.append({"raw_file": "frames/missing.jpg", "image_height": 40, "image_width": 80,
                  "polygons": []})
    (root / "ann.jsonl").write_text("\n".join(json.dumps(x) for x in lines) + "\n\n")
    return str(root), str(root / "ann.jsonl")


def test_seame_source_is_bit_equal_to_jax_in_both_formats(tmp_path):
    img_dir, ann = _seame_tree(tmp_path)
    port, ref = _both("seame", img_dir=img_dir, annotation_file=ann)
    assert len(port) == 2       # the missing image is filtered out
    _assert_same_samples(port, ref)
    for i in range(2):
        np.testing.assert_array_equal(port.rasterize(port.annotations[i]),
                                      ref.rasterize(ref.annotations[i]))
    assert set(np.unique(port.load(0)[1])) == {0, 1, 2}
    assert set(np.unique(port.load(1)[1])) == {0, 1}


def test_seame_source_raises_on_an_unreadable_image(tmp_path):
    img_dir, ann = _seame_tree(tmp_path)
    (tmp_path / "frames" / "b.png").write_bytes(b"corrupt")
    port, ref = _both("seame", img_dir=img_dir, annotation_file=ann)
    for src in (port, ref):
        with pytest.raises(ValueError, match="Could not read image"):
            src.load(1)


@pytest.mark.parametrize("kind", ["bdd100k", "carla", "seame"])
def test_without_cv2_the_file_sources_raise_naming_the_packed_route(tmp_path, monkeypatch,
                                                                     kind):
    img_dir, mask_dir = _tree(tmp_path, "bdd100k")
    _, ann = _seame_tree(tmp_path)
    monkeypatch.setitem(sys.modules, "cv2", None)     # import cv2 -> ImportError
    with pytest.raises(ImportError, match="cv2") as err:
        build_source(DatasetSourceConfig(kind=kind, img_dir=img_dir, mask_dir=mask_dir,
                                         annotation_file=ann), W, H)
    assert 'kind="packed"' in str(err.value)
    assert "python -m tpuseg_torch.tools.pack_dataset" in str(err.value)
    # the sources that need no decoder still build and load
    assert build_source(DatasetSourceConfig(kind="synthetic", num_samples=2), W, H).load(1)


# -- packing and the packed source ----------------------------------------------------


def _pack(tool, out, argv, width=W, height=H):
    assert tool.main(["--out", str(out), "--width", str(width), "--height", str(height),
                      *argv]) == 0


def _files(directory):
    return {n: (directory / n).read_bytes() for n in ("images.npy", "masks.npy", "meta.json")}


@pytest.mark.parametrize("case", ["synthetic", "bdd100k_skipped_tail"])
def test_the_port_packer_writes_the_jax_tools_files(tmp_path, case, capsys):
    if case == "synthetic":
        argv = ["--kind", "synthetic", "--num_samples", "7"]
    else:   # the corrupt image sorts last: a skipped tail to trim
        img_dir, mask_dir = _tree(tmp_path, "bdd100k", unreadable="zz9", extra_image=False)
        argv = ["--kind", "bdd100k", "--img_dir", img_dir, "--mask_dir", mask_dir]
    _pack(pack_dataset, tmp_path / "port", argv)
    port_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _pack(_jax_tool("pack_dataset"), tmp_path / "jax", argv)
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert port_line.pop("out") == str(tmp_path / "port")
    assert jax_line.pop("out") == str(tmp_path / "jax") and port_line == jax_line
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    want = 7 if case == "synthetic" else 5
    assert meta["count"] == want and len(np.load(tmp_path / "port" / "masks.npy")) == want
    if case == "synthetic":
        src = SyntheticSource(7, W, H)
        packed = PackedSource(str(tmp_path / "port"), W, H)
        _assert_same_samples(packed, src)


def test_the_port_reads_a_directory_packed_by_the_jax_tool(tmp_path):
    _pack(_jax_tool("pack_dataset"), tmp_path, ["--kind", "synthetic", "--num_samples", "9"])
    port, ref = _both("packed", packed_dir=str(tmp_path))
    _assert_same_samples(port, ref)
    idx = np.array([8, 0, 3, 3], np.int64)
    outs = [(np.zeros((4, H, W, 3), np.uint8), np.zeros((4, H, W), np.uint8)) for _ in range(2)]
    port.load_batch(idx, *outs[0])
    ref.load_batch(idx, *outs[1])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_a_packed_size_mismatch_raises(tmp_path):
    _pack(pack_dataset, tmp_path, ["--kind", "synthetic", "--num_samples", "2"])
    with pytest.raises(ValueError, match="re-pack"):
        PackedSource(str(tmp_path), W + 1, H)
    with pytest.raises(ValueError, match=f"{W}x{H}"):
        JaxPacked(str(tmp_path), W, H + 1)


def test_load_batch_gives_the_same_bytes_natively_and_with_numpy(tmp_path, monkeypatch):
    _pack(pack_dataset, tmp_path, ["--kind", "synthetic", "--num_samples", "11"])
    src = PackedSource(str(tmp_path), W, H)
    assert native_loader.available() and native_loader.library_path()
    idx = np.random.RandomState(4).randint(0, 11, 16).astype(np.int64)
    native = (np.zeros((16, H, W, 3), np.uint8), np.zeros((16, H, W), np.uint8))
    src.load_batch(idx, *native)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    plain = (np.zeros_like(native[0]), np.zeros_like(native[1]))
    src.load_batch(idx, *plain)
    np.testing.assert_array_equal(native[0], plain[0])
    np.testing.assert_array_equal(native[1], plain[1])
    np.testing.assert_array_equal(native[0], np.asarray(src.images)[idx])
    # into the numpy view of a torch tensor, as the pipeline gathers
    t_img, t_msk = torch.zeros((16, H, W, 3), dtype=torch.uint8), torch.zeros(
        (16, H, W), dtype=torch.uint8)
    native_loader.gather2(src.images, src.masks, idx, t_img.numpy(), t_msk.numpy())
    assert torch.equal(t_img, torch.from_numpy(native[0]))
    assert torch.equal(t_msk, torch.from_numpy(native[1]))


def test_gather2_refuses_what_would_read_out_of_bounds(tmp_path):
    _pack(pack_dataset, tmp_path, ["--kind", "synthetic", "--num_samples", "3"])
    src = PackedSource(str(tmp_path), W, H)
    img, msk = np.zeros((2, H, W, 3), np.uint8), np.zeros((2, H, W), np.uint8)
    with pytest.raises(IndexError):
        native_loader.gather2(src.images, src.masks, np.array([0, 3]), img, msk)
    with pytest.raises(ValueError, match="smaller"):
        native_loader.gather2(src.images, src.masks, np.array([0, 1, 2]), img, msk)
    with pytest.raises(ValueError, match="match"):
        native_loader.gather2(src.images, src.masks, np.array([0]), img[:, :, :-1], msk)
    with pytest.raises(TypeError):
        native_loader.gather2(list(src.images), src.masks, np.array([0]), img, msk)


def test_native_loader_builds_from_source_when_the_committed_one_fails(monkeypatch,
                                                                        tmp_path):
    monkeypatch.setattr(native_loader.LIBRARY, "committed", tmp_path / "missing.so")
    monkeypatch.setattr(native_loader.LIBRARY, "build_dir", tmp_path / "build")
    monkeypatch.setattr(native_loader.LIBRARY, "_loaded", None)
    path = native_loader.library_path()
    assert path is not None and path.startswith(str(tmp_path / "build"))
    images = np.arange(5 * 6, dtype=np.uint8).reshape(5, 2, 3)
    masks = np.arange(5 * 4, dtype=np.uint8).reshape(5, 4)
    img, msk = np.zeros((3, 2, 3), np.uint8), np.zeros((3, 4), np.uint8)
    native_loader.gather2(images, masks, np.array([4, 0, 2]), img, msk)
    np.testing.assert_array_equal(img, images[[4, 0, 2]])
    np.testing.assert_array_equal(msk, masks[[4, 0, 2]])


def test_without_a_library_the_loader_says_why_and_numpy_gathers(monkeypatch, tmp_path):
    monkeypatch.setattr(native_loader.LIBRARY, "committed", tmp_path / "missing.so")
    monkeypatch.setattr(native_loader.LIBRARY, "build_dir", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native_loader.LIBRARY, "_loaded", None)
    assert not native_loader.available() and native_loader.library_path() is None
    assert "missing.so" in native_loader.unavailable_reason()
    with pytest.raises(RuntimeError, match="did not load"):
        native_loader.gather2(np.zeros((1, 1), np.uint8), np.zeros((1, 1), np.uint8),
                              np.array([0]), np.zeros((1, 1), np.uint8),
                              np.zeros((1, 1), np.uint8))
    _pack(pack_dataset, tmp_path / "p", ["--kind", "synthetic", "--num_samples", "3"])
    src = PackedSource(str(tmp_path / "p"), W, H)
    img, msk = np.zeros((2, H, W, 3), np.uint8), np.zeros((2, H, W), np.uint8)
    src.load_batch(np.array([2, 1]), img, msk)
    np.testing.assert_array_equal(img, np.asarray(src.images)[[2, 1]])


# -- the input pipeline from a packed source -------------------------------------------


@pytest.mark.parametrize("cache_bytes", [0, 1 << 20], ids=["gather", "per_sample"])
def test_pipeline_batches_from_packed_sources_equal_jax(tmp_path, cache_bytes):
    """Two packed sources and a synthetic one: with no cache, batches of
    packed picks take the one-gather path (one source or both); a cache,
    or a synthetic pick, takes the per-sample path. Same batches as the
    JAX pipeline's for the same seed, either way."""
    _pack(pack_dataset, tmp_path / "a", ["--kind", "synthetic", "--num_samples", "13"])
    _pack(_jax_tool("pack_dataset"), tmp_path / "b", ["--kind", "synthetic",
                                                       "--num_samples", "6"])

    def combined(cls, packed, synth, weights):
        return cls([packed(str(tmp_path / "a"), W, H), packed(str(tmp_path / "b"), W, H),
                    synth(5, W, H, seed=7)][:len(weights)], weights=weights, val_split=0.2,
                   seed=3)

    from tpuseg.data.sources import SyntheticSource as JaxSynthetic

    for weights in ([1.0], [0.6, 0.4], [0.4, 0.3, 0.3]):
        port = InputPipeline(combined(CombinedDataset, PackedSource, SyntheticSource, weights),
                             batch_size=4, height=H, width=W, seed=5, cache_bytes=cache_bytes)
        ref = JaxPipeline(combined(JaxCombined, JaxPacked, JaxSynthetic, weights),
                          batch_size=4, height=H, width=W, seed=5, cache_bytes=cache_bytes)
        for (pi, pm), (ri, rm) in zip(port.train_batches(6), ref.train_batches(6)):
            np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
            np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))


def test_the_gather_path_writes_into_the_batch_buffers(tmp_path, monkeypatch):
    _pack(pack_dataset, tmp_path, ["--kind", "synthetic", "--num_samples", "8"])
    pipe = InputPipeline(CombinedDataset([PackedSource(str(tmp_path), W, H)]), batch_size=3,
                         height=H, width=W)
    seen = []
    real = native_loader.gather2
    monkeypatch.setattr(native_loader, "gather2",
                        lambda *a: (seen.append((a[3].shape, a[4].shape)), real(*a)))
    imgs, msks = pipe._assemble([(0, 5), (0, 1), (0, 5)])
    assert seen == [((3, H, W, 3), (3, H, W))]          # one call, the whole batch
    idx = pipe.combined.train_indices[0][[5, 1, 5]]
    np.testing.assert_array_equal(imgs.numpy(), np.asarray(pipe.combined.sources[0].images)[idx])
    np.testing.assert_array_equal(msks.numpy(), np.asarray(pipe.combined.sources[0].masks)[idx])


# -- class statistics ---------------------------------------------------------------


def _masks(n, seed, hw=(6, 9), high=12):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, high, hw).astype(np.uint8) for _ in range(n)]


def test_mask_class_counts_equal_jax():
    masks = _masks(5, 0) + [np.full((3, 3), 255, np.uint8)]
    for a, b in zip(stats.mask_class_counts(masks, 10), jstats.mask_class_counts(masks, 10)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("samples", [0, 3])
def test_compute_stats_equals_jax(samples):
    kw = dict(num_samples=6, car_prob=0.3, car_scale=0.5)
    port, ref = _both("synthetic", **kw)
    for a, b in zip(stats.compute_stats(port, 10, samples), jstats.compute_stats(ref, 10, samples)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scheme", ["median", "inverse"])
@pytest.mark.parametrize("counts", [[100, 5, 0, 7, 0, 0, 50, 1, 0, 2], [0] * 10, [3] * 10])
def test_suggest_weights_equals_jax(scheme, counts):
    np.testing.assert_array_equal(stats.suggest_weights(counts, scheme),
                                  jstats.suggest_weights(counts, scheme))


def _stream_pair(val_split=0.25):
    def make(cls, synth):
        return cls([synth(8, W, H, seed=1), synth(5, W, H, seed=2, car_prob=0.2),
                    synth(0, W, H)], weights=[0.7, 0.3, 0.5], val_split=val_split, seed=4)

    from tpuseg.data.sources import SyntheticSource as JaxSynthetic

    return make(CombinedDataset, SyntheticSource), make(JaxCombined, JaxSynthetic)


def test_stream_class_frequencies_and_auto_weights_equal_jax():
    port, ref = _stream_pair()
    for spf in (2, 256):
        np.testing.assert_array_equal(stats.stream_class_frequencies(port, 10, spf),
                                      jstats.stream_class_frequencies(ref, 10, spf))
    for spec in ("auto", "auto:median", "auto:inverse"):
        assert stats.resolve_auto_class_weights(port, 10, spec) == \
            jstats.resolve_auto_class_weights(ref, 10, spec)
    for mod, combined in ((stats, port), (jstats, ref)):
        with pytest.raises(ValueError, match="auto"):
            mod.resolve_auto_class_weights(combined, 10, "median")
        with pytest.raises(ValueError, match="scheme"):
            mod.resolve_auto_class_weights(combined, 10, "auto:bogus")


def test_stream_frequencies_refuse_an_empty_train_split():
    port, ref = _stream_pair(val_split=1.0)
    for mod, combined in ((stats, port), (jstats, ref)):
        with pytest.raises(ValueError, match="no non-empty train splits"):
            mod.stream_class_frequencies(combined, 10)


@pytest.mark.parametrize("argv", [["--kind", "synthetic", "--samples", "5"],
                                  ["--kind", "synthetic", "--samples", "4", "--scheme",
                                   "inverse", "--car_prob", "0.3"]])
def test_the_class_stats_tool_prints_the_jax_tools_line(argv, capsys):
    assert class_stats_tool.main(argv) == 0
    port = capsys.readouterr().out
    assert _jax_tool("class_stats").main(argv) == 0
    assert port == capsys.readouterr().out
    assert json.loads(port)["flag"].startswith("--train.class_weights=")


def test_the_class_stats_tool_reads_a_packed_directory(tmp_path, capsys):
    _pack(pack_dataset, tmp_path, ["--kind", "synthetic", "--num_samples", "4"])
    capsys.readouterr()
    argv = ["--kind", "packed", "--packed_dir", str(tmp_path), "--width", str(W),
            "--height", str(H)]
    assert class_stats_tool.main(argv) == 0
    port = capsys.readouterr().out
    assert _jax_tool("class_stats").main(argv) == 0
    assert port == capsys.readouterr().out and json.loads(port)["images"] == 4


# -- the Trainers' class_weights=auto -------------------------------------------------

JAX_TINY = ["--model.name=unet", "--model.base_filters=4", "--data.width=32",
            "--data.height=16", "--train.batch_size=8", "--train.checkpoint_dir=",
            "--train.log_every=0", "--data.val_split=0.25"]


def _trainers(flags):
    from tpuseg.configs import load_config as jax_load_config
    from tpuseg.train.trainer import Trainer as JaxTrainer

    srcs = dict(kind="synthetic", num_samples=16, weight=1.0, car_prob=0.4)
    jcfg = jax_load_config(JAX_TINY + flags)
    jcfg.data.sources = (JaxSourceConfig(**srcs),)
    pcfg = load_config(JAX_TINY + flags)
    pcfg.data.sources = (DatasetSourceConfig(**srcs),)
    return lambda: JaxTrainer(jcfg), lambda: Trainer(pcfg, device="cpu")


@pytest.mark.parametrize("spec", ["auto", "auto:inverse"])
def test_both_trainers_resolve_auto_class_weights_alike(spec, caplog):
    """The same weights, and the same log line, from both Trainers."""
    jax_make, port_make = _trainers([f"--train.class_weights={spec}", "--train.loss=ce"])
    caplog.set_level(logging.INFO)

    def resolved(make):
        caplog.clear()
        tr = make()
        lines = [r.getMessage() for r in caplog.records
                 if r.getMessage().startswith("resolved --train.class_weights")]
        assert len(lines) == 1, lines
        return tr, lines[0]

    (jt, jax_line), (pt, port_line) = resolved(jax_make), resolved(port_make)
    assert port_line == jax_line
    want = stats.resolve_auto_class_weights(pt.combined, 10, spec)
    assert pt.class_weights == want == jstats.resolve_auto_class_weights(jt.combined, 10, spec)
    assert "-> " + ",".join(f"{w:.4f}" for w in want) + " (" in port_line
    assert any(w > 0 for w in want) and len(want) == 10


@pytest.mark.parametrize("flags,match", [
    (["--train.class_weights=auto:bogus"], "scheme"),
    (["--train.class_weights=1,2,3"], "3 entries"),
    (["--train.class_weights=auto", "--train.loss=lovasz"], "class_weights"),
    (["--train.class_weights=auto", "--train.loss=dice"], "class_weights"),
])
def test_both_trainers_refuse_bad_class_weights(flags, match):
    for make in _trainers(flags):
        with pytest.raises(ValueError, match=match):
            make()


def test_the_trainer_trains_from_a_packed_directory_with_heavy_augment_and_auto(tmp_path):
    _pack(pack_dataset, tmp_path, ["--kind", "synthetic", "--num_samples", "16"], width=32)
    src = json.dumps([{"kind": "packed", "packed_dir": str(tmp_path), "weight": 1.0}])
    cfg = load_config(["--model.name=unet", "--model.base_filters=4", "--data.width=32",
                       f"--data.height={H}", "--train.batch_size=4", "--train.epochs=1",
                       "--train.steps_per_epoch=3", "--train.checkpoint_dir=",
                       "--train.log_every=0", "--data.val_split=0.25",
                       "--data.heavy_augment=true", "--train.class_weights=auto",
                       "--train.loss=ce+lovasz", f"--data.sources={src}"])
    tr = Trainer(cfg, device="cpu")
    hist = tr.train()
    assert len(tr.step_losses) == 3 and all(np.isfinite(tr.step_losses))
    assert np.isfinite(hist[-1]["val_miou"])
    assert tr.class_weights == stats.resolve_auto_class_weights(tr.combined, 10, "auto")


# -- visualize -----------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_blend_sample_and_class_histogram_equal_jax(alpha):
    image, mask = SyntheticSource(2, W, H, car_prob=0.5).load(1)
    np.testing.assert_array_equal(vis.blend_sample(image, mask, alpha),
                                  jvis.blend_sample(image, mask, alpha))
    assert vis.class_histogram(mask) == jvis.class_histogram(mask)


def test_visualize_main_writes_the_blended_sample(tmp_path, capsys):
    out = tmp_path / "s.png"
    assert vis.main(["--kind", "synthetic", "--idx", "1", "--out", str(out), "--width",
                     str(W), "--height", str(H)]) == 0
    image, mask = SyntheticSource(16, W, H).load(1)
    written = cv2.imread(str(out))[..., ::-1]
    np.testing.assert_array_equal(written, vis.blend_sample(image, mask))
    assert "road" in capsys.readouterr().out
