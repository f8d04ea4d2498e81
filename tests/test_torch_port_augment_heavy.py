"""The port's heavy and detection augmentation against the JAX module's.

The contract of random augmentation is distribution parity
(tpuseg/data/augment.py:18), so each deterministic part is held to its JAX
function with the parameters drawn from a JAX key exactly as the JAX
function draws them (the same splits): the perspective solve, the composed
heavy homography, the hue rotation, ColorJitter, the HSV and RGB shifts,
each blur, the heavy warp, and the whole heavy sample. Every gate and
branch of the port's own draws is within 4 sigma of the JAX module's over
4096 draws, the continuous parameters fill their ranges, masks are never
interpolated, and a generator seed repeats the output exactly. The
detection augment's boxes equal the JAX corner arithmetic under a fixed
matrix.

Tolerances: the 3x3 products and the 8x8 solve run in float32 in another
order (LAPACK's LU on both sides), so matrices agree to 1e-5 relative
(atol 1e-4 for pixel-scale translations); images in [0, 255] to 2e-3
levels (a few float32 ulps of 255 through a 3x3 colour product and a
mean); boxes to 1e-5 of the image size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.data import augment as jaug
from tpuseg_torch.data import augment

H, W = 16, 24
MAT_RTOL, MAT_ATOL = 1e-5, 1e-4
IMG_ATOL = 2e-3


def _keys(n, seed=0):
    return list(jax.random.split(jax.random.PRNGKey(seed), n))


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _jax_heavy_params(keys):
    """The heavy pipeline's parameters of one sample, drawn from its 17
    keys exactly as tpuseg/data/augment.py's _heavy_matrix and
    _heavy_sample draw them, in the port's ``heavy_params`` layout."""
    u = jax.random.uniform
    kb, kc, ks, kh = jax.random.split(keys[15], 4)
    hk, sk, vk = jax.random.split(keys[15], 3)
    kb1, kb2 = jax.random.split(keys[16])
    return {
        "flip": jax.random.bernoulli(keys[0], 0.6),
        "do_shift": jax.random.bernoulli(keys[1], 0.8),
        "branch": jax.random.randint(keys[2], (), 0, 3),
        "tx_left": u(keys[3], (), minval=-0.35, maxval=-0.15),
        "tx_right": u(keys[3], (), minval=0.15, maxval=0.35),
        "tx_mid": u(keys[3], (), minval=-0.1, maxval=0.1),
        "sc_mid": u(keys[4], (), minval=0.9, maxval=1.1),
        "rot_mid": jnp.deg2rad(u(keys[5], (), minval=-5.0, maxval=5.0)),
        "do_aff": jax.random.bernoulli(keys[6], 0.5),
        "a_sc": u(keys[7], (), minval=0.95, maxval=1.05),
        "a_tr": u(keys[8], (2,), minval=-0.05, maxval=0.05),
        "a_rot": jnp.deg2rad(u(keys[9], (), minval=-80.0, maxval=80.0)),
        "do_persp": jax.random.bernoulli(keys[10], 0.5),
        "p_scale": u(keys[11], (), minval=0.05, maxval=0.15),
        "p_normal": jax.random.normal(keys[12], (4, 2), dtype=jnp.float32),
        "do_color": jax.random.bernoulli(keys[13], 0.5),
        "which": jax.random.randint(keys[14], (), 0, 3),
        "cj_b": u(kb, (), minval=0.8, maxval=1.2),
        "cj_c": u(kc, (), minval=0.8, maxval=1.2),
        "cj_s": u(ks, (), minval=0.7, maxval=1.3),
        "cj_h": u(kh, (), minval=-0.1, maxval=0.1) * 2.0 * jnp.pi,
        "hsv_hue": u(hk, (), minval=-10.0, maxval=10.0) / 180.0 * jnp.pi,
        "hsv_sat": u(sk, (), minval=-20.0, maxval=20.0) / 255.0,
        "hsv_val": u(vk, (), minval=-15.0, maxval=15.0),
        "rgb": u(keys[15], (1, 1, 3), minval=-15.0, maxval=15.0).reshape(3),
        "do_blur": jax.random.bernoulli(kb1, 0.3),
        "blur": jax.random.randint(kb2, (), 0, 3),
    }


@jax.jit
def _jax_batch_params(parents):
    """_jax_heavy_params over parent keys [n], each split into 17 as the
    JAX batch fn splits a sample's key."""
    return jax.vmap(lambda k: _jax_heavy_params(jax.random.split(k, 17)))(parents)


def _port_params(parents):
    """The port's batched parameter dict drawn from JAX parent keys."""
    return {k: torch.from_numpy(np.array(v)) for k, v in _jax_batch_params(parents).items()}


def _sample_keys(n, seed=0):
    """``n`` samples' 17 keys each, as the JAX batch fn splits them."""
    return [jax.random.split(k, 17) for k in _keys(n, seed)]


# the JAX functions under test, compiled once (their per-sample bodies)
_jax_heavy_matrix = jax.jit(jaug._heavy_matrix, static_argnums=(1, 2))
_jax_heavy_sample = jax.jit(jaug._heavy_sample, static_argnums=(3, 4))


def _images(seed, b=1, h=H, w=W):
    return np.random.RandomState(seed).randint(0, 256, (b, h, w, 3)).astype(np.float32)


# -- geometry --------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_perspective_matrix_matches_jax(seed):
    key, skey = jax.random.split(jax.random.PRNGKey(seed))
    scale = float(jax.random.uniform(skey, (), minval=0.05, maxval=0.15))
    want = jaug._perspective_matrix(key, scale, W, H)
    jitter = jax.random.normal(key, (4, 2), dtype=jnp.float32) * scale * jnp.array(
        [[W, H]], dtype=jnp.float32)
    got = augment.perspective_matrix(_t(jitter)[None], W, H)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MAT_RTOL, atol=MAT_ATOL)
    # the corners land where the jitter put them
    src = np.array([[0, 0, 1], [W - 1, 0, 1], [W - 1, H - 1, 1], [0, H - 1, 1]], np.float64)
    mapped = src @ got.numpy().astype(np.float64).T
    np.testing.assert_allclose(mapped[:, :2] / mapped[:, 2:], src[:, :2] + np.asarray(jitter),
                               atol=1e-3)


def test_heavy_matrix_matches_jax_over_every_branch():
    keys = _sample_keys(48, seed=1)
    p = _port_params(jnp.stack(_keys(48, 1)))
    for gate in ("flip", "do_shift", "do_aff", "do_persp"):     # both sides of each gate
        assert 0 < int(p[gate].sum()) < len(keys), gate
    assert set(p["branch"].tolist()) == {0, 1, 2}
    got = augment.heavy_matrix(p, H, W)
    want = np.stack([np.asarray(_jax_heavy_matrix(k, H, W)) for k in keys])
    np.testing.assert_allclose(got.numpy(), want, rtol=MAT_RTOL, atol=MAT_ATOL)


def test_the_heavy_warp_matches_jax():
    """The warp's coordinates through a heavy matrix within 1e-3 px; from
    the same coordinates, bilinear samples to IMG_ATOL and nearest labels
    exactly."""
    keys = _sample_keys(6, seed=2)
    m = np.stack([np.asarray(_jax_heavy_matrix(k, H, W)) for k in keys])
    img, mask = _images(3, 6), np.random.RandomState(4).randint(0, 10, (6, H, W)).astype(np.uint8)
    sy, sx = augment.warp_coords(torch.linalg.inv_ex(_t(m)).inverse, H, W)
    for i in range(6):
        sy_j, sx_j = jaug._warp_coords(jnp.linalg.inv(m[i]), H, W)
        np.testing.assert_allclose(sy[i].numpy(), np.asarray(sy_j), atol=1e-3)
        np.testing.assert_allclose(sx[i].numpy(), np.asarray(sx_j), atol=1e-3)
        sy_t, sx_t = _t(sy_j)[None], _t(sx_j)[None]
        got = augment.sample_bilinear(_t(img[i:i + 1]), sy_t, sx_t)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(jaug._sample_bilinear(
            jnp.asarray(img[i]), sy_j, sx_j)), atol=IMG_ATOL)
        np.testing.assert_array_equal(
            augment.sample_nearest(_t(mask[i:i + 1]), sy_t, sx_t)[0].numpy(),
            np.asarray(jaug._sample_nearest(jnp.asarray(mask[i]), sy_j, sx_j)))


# -- colour ----------------------------------------------------------------------


@pytest.mark.parametrize("angle", [-0.6, 0.0, 0.17, 2.5])
def test_hue_rotate_matches_jax(angle):
    img = _images(5)
    got = augment.hue_rotate(_t(img), torch.tensor([angle]))
    want = jaug._hue_rotate(jnp.asarray(img[0]), jnp.float32(angle))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=IMG_ATOL)


@pytest.mark.parametrize("seed", range(3))
def test_color_jitter_matches_jax(seed):
    """Per sample: the contrast pivots on each image's own mean luma."""
    keys = _keys(3, seed + 10)
    img = _images(seed, 3)
    params = []
    for k in keys:
        kb, kc, ks, kh = jax.random.split(k, 4)
        params.append([jax.random.uniform(kb, (), minval=0.8, maxval=1.2),
                       jax.random.uniform(kc, (), minval=0.8, maxval=1.2),
                       jax.random.uniform(ks, (), minval=0.7, maxval=1.3),
                       jax.random.uniform(kh, (), minval=-0.1, maxval=0.1) * 2.0 * jnp.pi])
    b, c, s, h = (_t([float(p[i]) for p in params], np.float32) for i in range(4))
    got = augment.color_jitter(_t(img), b, c, s, h)
    for i, k in enumerate(keys):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(jaug._color_jitter(
            jnp.asarray(img[i]), k)), atol=IMG_ATOL)


@pytest.mark.parametrize("seed", range(3))
def test_hsv_and_rgb_shift_match_jax(seed):
    keys = _keys(3, seed + 20)
    img = _images(seed + 1, 3)
    hue, sat, val, rgb = [], [], [], []
    for k in keys:
        kh, ks, kv = jax.random.split(k, 3)
        hue.append(float(jax.random.uniform(kh, (), minval=-10.0, maxval=10.0) / 180.0 * jnp.pi))
        sat.append(float(jax.random.uniform(ks, (), minval=-20.0, maxval=20.0) / 255.0))
        val.append(float(jax.random.uniform(kv, (), minval=-15.0, maxval=15.0)))
        rgb.append(np.asarray(jax.random.uniform(k, (1, 1, 3), minval=-15.0,
                                                 maxval=15.0)).reshape(3))
    got_hsv = augment.hsv_shift(_t(img), _t(hue, np.float32), _t(sat, np.float32),
                                _t(val, np.float32))
    got_rgb = augment.rgb_shift(_t(img), _t(np.stack(rgb)))
    for i, k in enumerate(keys):
        np.testing.assert_allclose(got_hsv[i].numpy(), np.asarray(jaug._hsv_shift(
            jnp.asarray(img[i]), k)), atol=IMG_ATOL)
        np.testing.assert_array_equal(got_rgb[i].numpy(), np.asarray(jaug._rgb_shift(
            jnp.asarray(img[i]), k)))


def _key_for_blur(kind):
    """A key whose _blur3 draw picks ``kind``."""
    for k in _keys(64, 30):
        if int(jax.random.randint(k, (), 0, 3)) == kind:
            return k
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["gaussian", "motion_h", "motion_v"])
def test_each_blur_matches_jax(kind):
    img = _images(kind + 40, 2, h=7, w=9)
    got = augment.blur3(_t(img), torch.tensor([kind, kind]))
    k = _key_for_blur(kind)
    for i in range(2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(jaug._blur3(jnp.asarray(img[i]),
                                                                          k)), atol=IMG_ATOL)
    # edge padding: a constant image stays constant (to the float32 rounding
    # of three products by 1/3)
    flat = torch.full((1, 5, 6, 3), 7.0)
    torch.testing.assert_close(augment.blur3(flat, torch.tensor([kind])), flat, rtol=0,
                               atol=1e-5)


def test_blur_selects_per_sample():
    img = _t(_images(50, 3))
    got = augment.blur3(img, torch.tensor([2, 0, 1]))
    for i, kind in enumerate((2, 0, 1)):
        assert torch.equal(got[i], augment.blur3(img[i:i + 1], torch.tensor([kind]))[0])


def test_the_whole_heavy_sample_matches_jax():
    """Geometry, colour and blur from the same JAX keys: the port's
    deterministic half (heavy_matrix, warp, heavy_color) against
    _heavy_sample, images to 1e-2 levels (bilinear weights from
    coordinates 1e-3 px apart) and masks exactly where no coordinate sits
    near a rounding tie."""
    parents = _keys(24, 3)
    p = _port_params(jnp.stack(parents))
    assert set(p["which"][p["do_color"]].tolist()) == {0, 1, 2}
    assert set(p["blur"][p["do_blur"]].tolist()) >= {0, 1}
    img = np.random.RandomState(6).randint(0, 256, (24, H, W, 3)).astype(np.uint8)
    mask = np.random.RandomState(7).randint(0, 10, (24, H, W)).astype(np.uint8)
    m = augment.heavy_matrix(p, H, W)
    warped, got_mask = augment.warp(_t(img).float(), _t(mask), m)
    got = augment.heavy_color(warped, p)
    sy, sx = augment.warp_coords(torch.linalg.inv_ex(m).inverse, H, W)
    for i, k in enumerate(parents):
        want_img, want_mask = _jax_heavy_sample(jnp.asarray(img[i]), jnp.asarray(mask[i]), k,
                                                H, W)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want_img), atol=1e-2)
        frac = lambda c: np.abs(np.abs(c.numpy()) % 1.0 - 0.5)   # noqa: E731
        clear = (frac(sy[i]) > 1e-3) & (frac(sx[i]) > 1e-3)
        np.testing.assert_array_equal(got_mask[i].numpy()[clear], np.asarray(want_mask)[clear])


# -- the port's own draws ----------------------------------------------------------

N = 4096
GATES = {"flip": 0.6, "do_shift": 0.8, "do_aff": 0.5, "do_persp": 0.5, "do_color": 0.5,
         "do_blur": 0.3}
CHOICES = ("branch", "which", "blur")


def _jax_rates():
    """The JAX module's gate and branch frequencies over N samples' keys."""
    per = _jax_batch_params(jax.random.split(jax.random.PRNGKey(99), N))
    rates = {g: float(jnp.mean(per[g])) for g in GATES}
    rates.update({f"{c}={v}": float(jnp.mean(per[c] == v)) for c in CHOICES for v in range(3)})
    return rates


def test_every_gate_and_branch_is_within_4_sigma_of_jax():
    p = augment.heavy_params(N, torch.Generator().manual_seed(0), "cpu")
    want = _jax_rates()
    for name, rate in want.items():
        if "=" in name:
            key, v = name.split("=")
            got, prob = float((p[key] == int(v)).float().mean()), 1 / 3
        else:
            got, prob = float(p[name].float().mean()), GATES[name]
        sigma = np.sqrt(2 * prob * (1 - prob) / N)     # of a difference of two rates
        assert abs(got - rate) < 4 * sigma, (name, got, rate)
        assert abs(got - prob) < 4 * np.sqrt(prob * (1 - prob) / N), (name, got, prob)


@pytest.mark.parametrize("key,lo,hi", [
    ("tx_left", -0.35, -0.15), ("tx_right", 0.15, 0.35), ("tx_mid", -0.1, 0.1),
    ("sc_mid", 0.9, 1.1), ("rot_mid", -np.pi / 36, np.pi / 36), ("a_sc", 0.95, 1.05),
    ("a_tr", -0.05, 0.05), ("a_rot", -4 * np.pi / 9, 4 * np.pi / 9), ("p_scale", 0.05, 0.15),
    ("cj_b", 0.8, 1.2), ("cj_c", 0.8, 1.2), ("cj_s", 0.7, 1.3),
    ("cj_h", -0.2 * np.pi, 0.2 * np.pi), ("hsv_hue", -np.pi / 18, np.pi / 18),
    ("hsv_sat", -20 / 255, 20 / 255), ("hsv_val", -15.0, 15.0), ("rgb", -15.0, 15.0)])
def test_continuous_parameters_fill_their_ranges(key, lo, hi):
    v = augment.heavy_params(N, torch.Generator().manual_seed(1), "cpu")[key]
    span = hi - lo
    assert float(v.min()) >= lo - 1e-6 and float(v.max()) <= hi + 1e-6
    assert float(v.min()) < lo + 0.01 * span and float(v.max()) > hi - 0.01 * span
    assert abs(float(v.mean()) - (lo + hi) / 2) < 0.03 * span


def test_the_perspective_jitter_is_standard_normal():
    v = augment.heavy_params(N, torch.Generator().manual_seed(2), "cpu")["p_normal"]
    assert v.shape == (N, 4, 2)
    assert abs(float(v.mean())) < 0.02 and abs(float(v.std()) - 1.0) < 0.02


def test_heavy_augment_keeps_labels_and_repeats_for_a_seed():
    rng = np.random.RandomState(8)
    imgs = torch.from_numpy(rng.randint(0, 256, (64, H, W, 3)).astype(np.uint8))
    masks = torch.from_numpy(rng.choice([0, 3, 7], (64, H, W)).astype(np.uint8))
    fn = augment.make_augment_fn(H, W, heavy=True)
    x, y = fn(imgs, masks, torch.Generator().manual_seed(5))
    assert x.dtype == torch.float32 and y.dtype == torch.int64 and x.shape == imgs.shape
    assert set(torch.unique(y).tolist()) <= {0, 3, 7}       # nearest: never interpolated
    assert bool(torch.isfinite(x).all())
    x2, y2 = fn(imgs, masks, torch.Generator().manual_seed(5))
    assert torch.equal(x, x2) and torch.equal(y, y2)
    x3, _ = fn(imgs, masks, torch.Generator().manual_seed(6))
    assert not torch.equal(x, x3)
    # images stay in [0, 255] before normalization
    raw, _ = augment.heavy_augment(imgs, masks, torch.Generator().manual_seed(5))
    assert float(raw.min()) >= 0.0 and float(raw.max()) <= 255.0


def test_heavy_flag_without_augment_is_normalize_only():
    imgs = torch.from_numpy(np.random.RandomState(9).randint(0, 256, (2, H, W, 3)).astype(
        np.uint8))
    masks = torch.zeros((2, H, W), dtype=torch.uint8)
    x, _ = augment.make_augment_fn(H, W, heavy=True, augment=False)(imgs, masks, None)
    assert torch.equal(x, augment.normalize_images(imgs))
    a, _ = augment.augment_batch(imgs, masks, torch.Generator().manual_seed(3), heavy=True)
    b, _ = augment.make_augment_fn(H, W, heavy=True)(imgs, masks,
                                                    torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


# -- detection ---------------------------------------------------------------------


def _boxes(seed, b, n):
    rng = np.random.RandomState(seed)
    wh = rng.uniform(0.05, 0.5, (b, n, 2))
    c = rng.uniform(-0.1, 1.1, (b, n, 2))
    return np.concatenate([c, wh], -1).astype(np.float32), rng.rand(b, n) < 0.8


@pytest.mark.parametrize("seed", range(3))
def test_detection_boxes_equal_jax_under_a_fixed_matrix(seed, monkeypatch):
    keys = _sample_keys(4, seed=seed + 60)
    m = np.stack([np.asarray(_jax_heavy_matrix(k, H, W)) for k in keys])
    boxes, valid = _boxes(seed, 4, 12)
    got_b, got_v = augment.detection_boxes(_t(m), _t(boxes), _t(valid), H, W)
    img = np.random.RandomState(seed).randint(0, 256, (H, W, 3)).astype(np.uint8)
    for i in range(4):
        monkeypatch.setattr(jaug, "_heavy_matrix", lambda keys, h, w, m=m[i]: jnp.asarray(m))
        _, want_b, want_v = jaug._detection_sample(jnp.asarray(img), jnp.asarray(boxes[i]),
                                                   jnp.asarray(valid[i]), keys[i][0], H, W)
        np.testing.assert_array_equal(got_v[i].numpy(), np.asarray(want_v))
        np.testing.assert_allclose(got_b[i].numpy(), np.asarray(want_b), atol=1e-5)
    assert bool((got_b[~got_v] == 0).all())


def test_detection_boxes_keep_by_visibility():
    """The identity keeps an in-image box as it is; a box half outside is
    kept at min_visibility .3 and dropped at .6; an invalid box stays out."""
    eye = torch.eye(3)[None]
    boxes = torch.tensor([[[0.5, 0.5, 0.2, 0.2], [0.0, 0.5, 0.2, 0.2], [0.5, 0.5, 0.2, 0.2]]])
    valid = torch.tensor([[True, True, False]])
    b, v = augment.detection_boxes(eye, boxes, valid, H, W)
    assert v.tolist() == [[True, True, False]]
    torch.testing.assert_close(b[0, 0], boxes[0, 0])
    torch.testing.assert_close(b[0, 1], torch.tensor([0.05, 0.5, 0.1, 0.2]))
    _, v = augment.detection_boxes(eye, boxes, valid, H, W, min_visibility=0.6)
    assert v.tolist() == [[True, False, False]]


def test_the_detection_augment_runs_and_repeats():
    imgs = torch.from_numpy(np.random.RandomState(11).randint(0, 256, (5, H, W, 3)).astype(
        np.uint8))
    boxes, valid = _boxes(12, 5, 6)
    fn = augment.make_detection_augment_fn(H, W)
    x, b, v = fn(imgs, _t(boxes), _t(valid), torch.Generator().manual_seed(0))
    assert x.shape == imgs.shape and b.shape == (5, 6, 4) and v.dtype == torch.bool
    assert bool(torch.isfinite(x).all()) and not bool((v & ~_t(valid)).any())
    assert float(b.min()) >= 0.0 and float(b.max()) <= 1.0 + 1e-6
    x2, b2, v2 = fn(imgs, _t(boxes), _t(valid), torch.Generator().manual_seed(0))
    assert torch.equal(x, x2) and torch.equal(b, b2) and torch.equal(v, v2)
    with pytest.raises(ValueError, match="are not"):
        fn(imgs[:, :-1], _t(boxes), _t(valid), torch.Generator())
