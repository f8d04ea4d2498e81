"""The port's data layer (tpuseg_torch/data) against the JAX package's.

The host side is numpy in both packages and must agree exactly: synthetic
samples, the seeded split, the weighted sampler's index stream (also after
``state``/``restore``) and the batches of ``InputPipeline``. On the device
side, normalize-only and the deterministic warp (a fixed homography through
``warp_coords``, ``sample_bilinear`` and ``sample_nearest``) are held to
JAX's functions; random augmentation, whose contract is distribution parity
(tpuseg/data/augment.py:18), is checked by its flip rate and its parameter
ranges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.configs import DatasetSourceConfig as JaxSourceConfig
from tpuseg.data import augment as jaug
from tpuseg.data.combined import CombinedDataset as JaxCombined
from tpuseg.data.combined import WeightedMixSampler as JaxSampler
from tpuseg.data.pipeline import InputPipeline as JaxPipeline
from tpuseg.data.sources import SyntheticSource as JaxSynthetic
from tpuseg.data.sources import build_source as jax_build_source
from tpuseg_torch.configs import DatasetSourceConfig
from tpuseg_torch.data import augment
from tpuseg_torch.data.combined import CombinedDataset, WeightedMixSampler
from tpuseg_torch.data.pipeline import InputPipeline, SampleCache
from tpuseg_torch.data.sources import SyntheticSource, build_source

H, W = 32, 48


@pytest.mark.parametrize("kw", [dict(), dict(seed=3, car_prob=0.4, car_scale=0.5)],
                         ids=["default", "imbalanced"])
def test_synthetic_source_is_bit_equal(kw):
    port, ref = SyntheticSource(6, W, H, **kw), JaxSynthetic(6, W, H, **kw)
    for i in range(6):
        for a, b in zip(port.load(i), ref.load(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _tiny_trees(root):
    """One-sample BDD100K, CARLA, SEAME and packed datasets under ``root``."""
    import json

    import cv2

    rng = np.random.RandomState(0)
    for kind, ext in (("bdd100k", ".jpg"), ("carla", ".png")):
        (root / kind / "images").mkdir(parents=True)
        (root / kind / "masks").mkdir()
        cv2.imwrite(str(root / kind / "images" / f"a{ext}"),
                    rng.randint(0, 255, (21, 35, 3), np.uint8))
        cv2.imwrite(str(root / kind / "masks" / "a.png"), rng.randint(0, 25, (21, 35), np.uint8))
    cv2.imwrite(str(root / "s.jpg"), rng.randint(0, 255, (20, 30, 3), np.uint8))
    (root / "s.jsonl").write_text(json.dumps({
        "raw_file": "s.jpg", "image_height": 20, "image_width": 30,
        "polygons": [[[0, 19], [29, 19], [15, 8]]]}))
    np.save(root / "images.npy", rng.randint(0, 255, (3, H, W, 3), np.uint8))
    np.save(root / "masks.npy", rng.randint(0, 10, (3, H, W), np.uint8))
    (root / "meta.json").write_text(json.dumps({"width": W, "height": H, "count": 3}))
    return {k: dict(img_dir=str(root / k / "images"), mask_dir=str(root / k / "masks"))
            for k in ("bdd100k", "carla")} | {
        "seame": dict(img_dir=str(root), annotation_file=str(root / "s.jsonl")),
        "packed": dict(packed_dir=str(root))}


def test_build_source(tmp_path):
    cfg = dict(kind="synthetic", num_samples=5, car_prob=0.5)
    src, ref = build_source(DatasetSourceConfig(**cfg), W, H), \
        jax_build_source(JaxSourceConfig(**cfg), W, H)
    assert len(src) == len(ref) == 5
    np.testing.assert_array_equal(src.load(4)[1], ref.load(4)[1])
    trees = _tiny_trees(tmp_path)
    for kind in ("bdd100k", "carla", "seame", "packed"):
        src, ref = build_source(DatasetSourceConfig(kind=kind, **trees[kind]), W, H), \
            jax_build_source(JaxSourceConfig(kind=kind, **trees[kind]), W, H)
        assert type(src).__name__ == type(ref).__name__ and len(src) == len(ref) > 0, kind
        for a, b in zip(src.load(len(src) - 1), ref.load(len(ref) - 1)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        build_source(DatasetSourceConfig(kind="nope"), W, H)


def _combined(cls, synth):
    sources = [synth(20, W, H, seed=1), synth(7, W, H, seed=2), synth(0, W, H)]
    return cls(sources, weights=[0.5, 0.2, 0.3], val_split=0.25, seed=42)


def test_combined_split_and_sampler_stream_are_equal():
    port, ref = _combined(CombinedDataset, SyntheticSource), _combined(JaxCombined, JaxSynthetic)
    for a, b in zip(port.train_indices + port.val_indices, ref.train_indices + ref.val_indices):
        np.testing.assert_array_equal(a, b)
    assert port.summary() == ref.summary()
    ps, rs = WeightedMixSampler(port, seed=9), JaxSampler(ref, seed=9)
    np.testing.assert_array_equal(ps.probs, rs.probs)
    assert ps.sample(50) == rs.sample(50)
    state = ps.state()
    assert state == rs.state()
    first = ps.sample(30)
    assert first == rs.sample(30)
    ps.restore(state)
    rs.restore(state)
    assert ps.sample(30) == first == rs.sample(30)


def test_input_pipeline_batches_are_equal():
    mk = lambda cls, synth: _combined(cls, synth)
    port = InputPipeline(mk(CombinedDataset, SyntheticSource), batch_size=4, height=H,
                         width=W, device="cpu", seed=5, cache_bytes=1 << 20)
    ref = JaxPipeline(mk(JaxCombined, JaxSynthetic), batch_size=4, height=H, width=W,
                      seed=5, cache_bytes=1 << 20)
    got, want = list(port.train_batches(3)), list(ref.train_batches(3))
    assert len(got) == len(want) == 3
    for (gi, gm), (wi, wm) in zip(got, want):
        assert gi.dtype == torch.uint8 and gi.shape == (4, H, W, 3)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert port.state() == ref.state()
    for _ in range(2):          # the second pass replays the eval cache
        ev, ew = list(port.eval_batches()), list(ref.eval_batches())
        assert [n for *_, n in ev] == [n for *_, n in ew] == [4, 2]
        for (gi, gm, _), (wi, wm, _) in zip(ev, ew):
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert port._eval_cache is not None


def test_pipeline_surfaces_loader_errors_and_stops_early():
    class Broken(SyntheticSource):
        def load(self, idx):
            raise OSError("disk")

    pipe = InputPipeline(CombinedDataset([Broken(4, W, H)]), 2, H, W)
    with pytest.raises(OSError, match="disk"):
        list(pipe.train_batches(2))
    pipe = InputPipeline(CombinedDataset([SyntheticSource(8, W, H)]), 2, H, W)
    gen = pipe.train_batches(100)
    next(gen)
    gen.close()                 # the producer thread stops


def test_sample_cache_is_bounded():
    cache = SampleCache(budget_bytes=250)
    arr = lambda v: (np.full(100, v, np.uint8),)
    for k in range(3):
        assert cache.get(k, lambda k=k: arr(k))[0][0] == k
    assert cache.used == 200 and 0 not in cache._d
    assert cache.get(2, lambda: arr(9))[0][0] == 2          # a hit, not a reload


def _u8(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def test_normalize_only_matches_jax():
    """Bit-equal to JAX's normalize_images run eagerly; within one f32 ulp
    (rtol 1e-6) of the jitted augment fn, whose fused XLA arithmetic rounds
    differently; the masks exactly."""
    imgs, masks = _u8(0, (2, H, W, 3)), _u8(1, (2, H, W)) % 10
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    want_x, want_y = jaug.make_augment_fn(H, W, augment=False, mean=mean, std=std)(
        jnp.asarray(imgs), jnp.asarray(masks), None)
    x, y = augment.make_augment_fn(H, W, augment=False, mean=mean, std=std)(
        torch.from_numpy(imgs), torch.from_numpy(masks))
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jaug.normalize_images(jnp.asarray(imgs), mean, std)))
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
    assert y.dtype == torch.int64


def test_homography_builders_match_jax():
    ang, sc = np.float32(0.3), np.float32(1.04)
    got = augment.translate(torch.tensor([3.0]), torch.tensor([-2.0])) @ \
        augment.rot_scale_about_center(torch.tensor([ang]), torch.tensor([sc]), W, H) @ \
        augment.hflip_matrix(1, W, "cpu")
    want = jaug._translate(3.0, -2.0) @ jaug._rot_scale_about_center(ang, sc, W, H) @ \
        jaug._hflip_matrix(W)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_fixed_matrix_warp_matches_jax():
    """Coordinates at 1e-4 px (a 3x3 inverse and product in f32, in another
    order); then, from the same coordinates, the bilinear samples at
    rtol 1e-6 / atol 1e-4 of the 0..255 range and the nearest samples
    exactly."""
    m = np.array([[0.97, 0.12, -3.5], [-0.1, 1.03, 2.25], [0.0, 0.0, 1.0]], np.float32)
    inv = np.linalg.inv(m).astype(np.float32)
    sy_j, sx_j = jaug._warp_coords(jnp.asarray(inv), H, W)
    sy, sx = augment.warp_coords(torch.from_numpy(inv)[None], H, W)
    np.testing.assert_allclose(sy[0].numpy(), np.asarray(sy_j), atol=1e-4)
    np.testing.assert_allclose(sx[0].numpy(), np.asarray(sx_j), atol=1e-4)
    img, mask = _u8(2, (H, W, 3)).astype(np.float32), _u8(3, (H, W)) % 10
    sy_t, sx_t = (torch.tensor(np.asarray(a))[None] for a in (sy_j, sx_j))
    got = augment.sample_bilinear(torch.from_numpy(img)[None], sy_t, sx_t)[0]
    want = jaug._sample_bilinear(jnp.asarray(img), sy_j, sx_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
    got_m = augment.sample_nearest(torch.from_numpy(mask)[None], sy_t, sx_t)[0]
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(jaug._sample_nearest(
        jnp.asarray(mask), sy_j, sx_j)))


def test_hflip_warp_is_an_exact_flip():
    imgs, masks = _u8(4, (2, H, W, 3)), _u8(5, (2, H, W))
    x, y = augment.warp(torch.from_numpy(imgs).float(), torch.from_numpy(masks),
                        augment.hflip_matrix(2, W, "cpu"))
    np.testing.assert_array_equal(x.numpy(), imgs[:, :, ::-1].astype(np.float32))
    np.testing.assert_array_equal(y.numpy(), masks[:, :, ::-1])


def test_standard_augment_distribution():
    g = torch.Generator().manual_seed(0)
    n = 4000
    p = augment.standard_params(n, g, "cpu")
    for key in ("flip", "do_ssr", "do_bc"):
        assert abs(float(p[key].float().mean()) - 0.5) < 0.04, key
    for key, lo, hi in (("shift", -0.05, 0.05), ("scale", 0.95, 1.05),
                        ("angle", -np.pi / 18, np.pi / 18), ("alpha", 0.8, 1.2),
                        ("beta", -0.2, 0.2)):
        v = p[key]
        assert float(v.min()) >= lo and float(v.max()) <= hi, key
        assert float(v.min()) < lo + 0.02 * (hi - lo) and float(v.max()) > hi - 0.02 * (hi - lo)
        assert abs(float(v.mean()) - (lo + hi) / 2) < 0.03 * (hi - lo), key
    # end to end: flips show up at the JAX module's rate, masks keep their
    # labels (nearest, never interpolated), images stay in range
    imgs = np.zeros((400, 8, 16, 3), np.uint8)
    imgs[:, :, :8] = 255                                  # bright left half
    masks = np.zeros((400, 8, 16), np.uint8)
    masks[:, :, :8] = 3
    fn = augment.make_augment_fn(8, 16)
    x, y = fn(torch.from_numpy(imgs), torch.from_numpy(masks), torch.Generator().manual_seed(1))
    assert set(torch.unique(y).tolist()) <= {0, 3}
    right_bright = (y[:, 4, 12] == 3).float().mean()
    assert abs(float(right_bright) - 0.5) < 0.08
    assert bool(torch.isfinite(x).all()) and x.dtype == torch.float32
    # the heavy pipeline keeps the labels too
    _, y = augment.make_augment_fn(8, 16, heavy=True)(
        torch.from_numpy(imgs[:8]), torch.from_numpy(masks[:8]), torch.Generator().manual_seed(1))
    assert set(torch.unique(y).tolist()) <= {0, 3}
