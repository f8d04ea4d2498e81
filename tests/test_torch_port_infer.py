"""The port's serving pieces against the JAX package's, on the CPU.

Morphology, the uint8 INTER_LINEAR replica, the nibble unpack, the native
postprocess library, the overlay, the Predictor's serving options and
guards, the VideoPipeline and the ``tpuseg_torch.inference`` entry point.
Both packages load the same weights (a reference ``.pth``) and see the
same seeded inputs. Class maps compared with the JAX package follow the
C5 rule (ROADMAP.md): >= 99.9% of pixels agree, and every pixel where
JAX's top-two logit margin exceeds 1e-3 agrees. Everything else here is
bit-equal: masks, resized bytes, unpacked ids, overlays, and the port's
routes against one another.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuseg.configs import ModelConfig as JaxModelConfig
from tpuseg.data.augment import normalize_images as jax_normalize
from tpuseg.infer import postprocess as jax_post
from tpuseg.infer import video as jax_video
from tpuseg.infer.predictor import Predictor as JaxPredictor, unpack4_host as jax_unpack4
from tpuseg.ops import morphology as jax_morph, native_post as jax_native
from tpuseg.ops.resize import resize_bilinear as jax_resize, resize_nearest as jax_nearest
from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core.prng import make_generator
from tpuseg_torch.core.weights import init_weights
from tpuseg_torch.infer import postprocess as post, video as port_video
from tpuseg_torch.infer.predictor import Predictor, unpack4_host
from tpuseg_torch.models.registry import build_model
from tpuseg_torch.ops import morphology, native_post
from tpuseg_torch.ops.resize import resize_linear_u8_host

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "assets", "demo.mp4")
MODEL_HW, FRAME_HW = (32, 64), (60, 128)
MARGIN = 1e-3
UNET = dict(name="unet", base_filters=8)
# cv2 refused inside a subprocess: the host of the card has no cv2
REFUSE_CV2 = textwrap.dedent("""
    import importlib.abc, sys
    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] == "cv2":
                raise ImportError("refused: " + name)
    sys.meta_path.insert(0, Refuse())
""")


# -- fixtures -----------------------------------------------------------------


def _seeded_pth(path, head_bias: str, road: float, car: float, **model_kw) -> str:
    """Seeded weights with random BatchNorm statistics, saved as a
    reference-named ``.pth``; the head's road and car biases are raised so
    that both classes show on noise and demo frames."""
    model = build_model(ModelConfig(**model_kw))
    init_weights(model, make_generator(0), random_bn=True)
    sd = model.state_dict()
    sd[head_bias][1] += road
    sd[head_bias][2] += car
    torch.save(sd, path)
    return str(path)


@pytest.fixture(scope="module")
def flagship_pth(tmp_path_factory):
    return _seeded_pth(tmp_path_factory.mktemp("infer") / "flagship.pth", "outc.conv.3.bias",
                       2.0, 1.6)


@pytest.fixture(scope="module")
def unet_pth(tmp_path_factory):
    return _seeded_pth(tmp_path_factory.mktemp("infer") / "unet.pth", "sem_out.conv.3.bias",
                       4.0, 3.0, **UNET)


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(7).randint(0, 256, (2, *FRAME_HW, 3), np.uint8)


@pytest.fixture(scope="module")
def demo_frames():
    cap = cv2.VideoCapture(DEMO)
    out = []
    while len(out) < 12:
        ok, f = cap.read()
        assert ok
        out.append(f)
    cap.release()
    return out


def _confident(jp: JaxPredictor, frames: np.ndarray, out_hw) -> np.ndarray:
    """Pixels (at ``out_hw``) where the JAX logits' top-two margin > MARGIN,
    on the model input the JAX Predictor builds (host or device resize)."""
    x = jnp.asarray(jp._maybe_host_resize(frames), jnp.float32)
    if x.shape[1:3] != tuple(jp.input_hw):
        x = jax_resize(x, *jp.input_hw)
    x = jax_normalize(x, jp.normalize_mean, jp.normalize_std)
    logits = jax.jit(lambda v, x: jp.model.apply(v, x, train=False))(jp.variables, x)
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]).astype(np.float32)
    return np.asarray(jax_nearest(jnp.asarray(margin), *out_hw)) > MARGIN


def _c5(got: np.ndarray, want: np.ndarray, confident: np.ndarray) -> None:
    """The C5 rule: >= 99.9% agreement, equality where JAX is confident."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    same = got == want
    assert same.mean() >= 0.999
    assert same[confident].all()


# -- morphology ---------------------------------------------------------------


def _border_masks():
    """Seeded masks [3, 23, 31] with foreground on every border and corner."""
    rng = np.random.RandomState(11)
    m = rng.rand(3, 23, 31) > 0.55
    m[0, 0, :] = m[0, :, 0] = True
    m[1, -1, :] = m[1, :, -1] = True
    m[2, :2, :2] = m[2, -2:, -2:] = m[2, :2, -2:] = m[2, -2:, :2] = True
    m[2, 5:9, 10:12] = False
    return m


@pytest.mark.parametrize("op", ["dilate", "erode", "morph_close"])
@pytest.mark.parametrize("k", [3, 5])
def test_morphology_matches_jax_and_cv2(op, k):
    masks = _border_masks()
    got = getattr(morphology, op)(torch.from_numpy(masks), k).numpy()
    want = np.asarray(getattr(jax_morph, op)(jnp.asarray(masks), k))
    assert got.dtype == np.bool_ and got.shape == masks.shape
    np.testing.assert_array_equal(got, want)
    kernel = np.ones((k, k), np.uint8)
    for m, g in zip(masks.astype(np.uint8) * 255, got):
        if op == "morph_close":
            ref = cv2.morphologyEx(m, cv2.MORPH_CLOSE, kernel)
        else:
            ref = getattr(cv2, op)(m, kernel)
        np.testing.assert_array_equal(g, ref == 255)


def test_morphology_refuses_an_even_kernel():
    with pytest.raises(ValueError, match="odd"):
        morphology.morph_close(torch.zeros(4, 4, dtype=torch.bool), 4)


# -- the uint8 INTER_LINEAR replica ---------------------------------------------


@pytest.mark.parametrize("src,dst", [
    ((360, 640), (128, 256)), ((720, 1280), (128, 256)), ((180, 320), (128, 256)),
    ((60, 128), (32, 64)), ((61, 127), (32, 64)), ((100, 100), (128, 256)),
    ((256, 512), (128, 256)), ((128, 256), (128, 256)),
], ids=lambda s: "x".join(map(str, s)))
def test_resize_linear_u8_host_is_bit_equal_to_cv2(src, dst):
    rng = np.random.RandomState(sum(src) + sum(dst))
    f = rng.randint(0, 256, (2, *src, 3), np.uint8)
    f[1, : src[0] // 2] = 255          # saturated rows, then hard edges
    f[1, src[0] // 2:] = (rng.rand(src[0] - src[0] // 2, src[1], 3) > 0.5) * 255
    want = np.stack([cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR) for x in f])
    np.testing.assert_array_equal(resize_linear_u8_host(f, *dst), want)


# -- Predictor: the nibble unpack, the guards, C1 --------------------------------


def test_unpack4_host_matches_jax():
    packed = np.random.RandomState(2).randint(0, 256, (3, 5, 7), np.uint8)
    got = unpack4_host(packed)
    assert got.shape == (3, 5, 14)
    np.testing.assert_array_equal(got, jax_unpack4(packed))


class _Mesh:
    """A stand-in for a mesh with a 3-way data axis (the port reads only its
    ``shape`` mapping before the guard)."""
    shape = {"data": 3}


GUARDS = {
    "mesh-use_pallas": (dict(use_pallas=True), dict(mesh=True)),
    "mesh-batch": (dict(), dict(mesh=True, batch_size=8)),
    "artifact-mesh": (dict(), dict(mesh=True, batch_size=6, artifact="model.stablehlo")),
    "pack4-classes": (dict(num_classes=17), dict(fetch_pack4=True)),
    "pack4-device_close": (dict(), dict(fetch_pack4=True, device_close=True)),
    "pack4-colorize": (dict(), dict(fetch_pack4=True, colorize_on_device=True)),
    "pack4-device_upscale": (dict(), dict(fetch_pack4=True, upscale_on_host=False)),
    "pack4-odd_width": (dict(), dict(fetch_pack4=True, input_hw=(32, 63))),
    "device_close-host_upscale": (dict(), dict(device_close=True)),
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_predictor_guards_raise_the_jax_value_errors(case):
    model_kw, kw = GUARDS[case]
    kw = dict(kw)
    jax_kw, port_kw = dict(kw), dict(kw)
    if kw.pop("mesh", False):
        jax_kw["mesh"] = jax.sharding.Mesh(np.array(jax.devices()[:3]), ("data",))
        port_kw["mesh"] = _Mesh()
    with pytest.raises(ValueError) as want:
        JaxPredictor(JaxModelConfig(**model_kw), **jax_kw)
    first = str(want.value).split(";")[0]
    with pytest.raises(ValueError, match=re.escape(first)):
        Predictor(ModelConfig(**model_kw), device="cpu", **port_kw)


def test_c1_use_pallas_with_fetch_pack4_raises_in_the_port_only():
    """ROADMAP C1: use_pallas forces colorize on, so fetch_pack4 would
    unpack ids that were never packed. The JAX Predictor takes the
    combination; the port checks the effective colorize flag and raises."""
    kw = dict(input_hw=MODEL_HW, batch_size=2, fetch_pack4=True)
    jp = JaxPredictor(JaxModelConfig(use_pallas=True, **UNET), **kw)
    assert jp.colorize_on_device and jp.fetch_pack4
    with pytest.raises(ValueError, match="use_pallas forces colorize_on_device on"):
        Predictor(ModelConfig(use_pallas=True, **UNET), device="cpu", **kw)


# -- Predictor options against the JAX Predictor --------------------------------


def _pair(pth, **kw):
    kw = dict(checkpoint=pth, input_hw=MODEL_HW, batch_size=2, **kw)
    return JaxPredictor(JaxModelConfig(), **kw), Predictor(ModelConfig(), device="cpu", **kw)


def test_fetch_pack4_matches_jax_and_the_default_route(flagship_pth, frames):
    jp, tp = _pair(flagship_pth, fetch_pack4=True)
    got = tp(frames)
    packed = tp.predict_async(frames)
    assert tuple(packed.shape) == (2, MODEL_HW[0], MODEL_HW[1] // 2)
    np.testing.assert_array_equal(got, Predictor(ModelConfig(), checkpoint=flagship_pth,
                                                 input_hw=MODEL_HW, device="cpu")(frames))
    _c5(got, jp(frames), _confident(jp, frames, FRAME_HW))


def test_device_close_matches_jax_and_packs_the_close_of_its_road(flagship_pth, frames):
    jp, tp = _pair(flagship_pth, device_close=True, upscale_on_host=False)
    got, want = tp(frames), np.asarray(jp(frames))
    assert got.shape == (2, *FRAME_HW)
    _c5(got & 0x7F, want & 0x7F, _confident(jp, frames, FRAME_HW))
    road = (got & 0x7F) == post.ROAD_CLASS
    assert road.any() and not road.all()
    closed = morphology.morph_close(torch.from_numpy(road), 5).numpy()
    np.testing.assert_array_equal(got >= 0x80, closed)
    for r, c in zip(road, closed):
        np.testing.assert_array_equal(native_post.morph_close(r.astype(np.uint8) * 255) == 255, c)
    plain = Predictor(ModelConfig(), checkpoint=flagship_pth, input_hw=MODEL_HW,
                      upscale_on_host=False, device="cpu")(frames)
    np.testing.assert_array_equal(got & 0x7F, plain)


@pytest.fixture(scope="module")
def no_cv2_run(flagship_pth, frames, demo_frames, tmp_path_factory):
    """The port with cv2 refused, in a subprocess: preprocess_on_host on
    the numpy replica, and the postprocess on the native library."""
    tmp = tmp_path_factory.mktemp("nocv2")
    classes = _scene_classes(demo_frames[0].shape[:2])
    closed = cv2.morphologyEx((classes == 1).astype(np.uint8) * 255, cv2.MORPH_CLOSE,
                              np.ones((5, 5), np.uint8))
    np.savez(tmp / "in.npz", frames=frames, frame_bgr=demo_frames[0], classes=classes,
             closed=closed)
    code = REFUSE_CV2 + textwrap.dedent(f"""
        import numpy as np
        from tpuseg_torch.configs import ModelConfig
        from tpuseg_torch.infer import postprocess as post
        from tpuseg_torch.infer.predictor import Predictor
        from tpuseg_torch.ops import native_post
        d = np.load({str(tmp / "in.npz")!r})
        p = Predictor(ModelConfig(), checkpoint={flagship_pth!r}, input_hw={MODEL_HW!r},
                      batch_size=2, preprocess_on_host=True, device="cpu")
        out = dict(route=np.array(p.preprocess_route), maps=p(d["frames"]),
                   lib=np.array(native_post.library_path()))
        f, c = d["frame_bgr"], d["classes"]
        for closed in (False, True):
            for pre in (False, True):
                r, det = post.overlay_predictions(
                    f, c, car_boxes=False,
                    precolored_bgr=post.COLOR_MAP_BGR[c] if pre else None,
                    closed_road=d["closed"] if closed else None)
                out[f"overlay_{{closed}}_{{pre}}"] = r
        out["cleaned"] = post.clean_road_mask(c)
        out["cleaned_closed"] = post.clean_road_mask(c, closed_road=d["closed"])
        try:
            post.overlay_predictions(f, c, car_boxes=True)
        except post.Cv2Missing as e:
            out["car_boxes_error"] = np.array(str(e))
        import sys
        assert "cv2" not in sys.modules
        np.savez({str(tmp / "out.npz")!r}, **out)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return dict(np.load(tmp / "out.npz"))


def test_preprocess_on_host_matches_jax_on_both_host_routes(flagship_pth, frames, no_cv2_run):
    jp, tp = _pair(flagship_pth, preprocess_on_host=True)
    assert tp.preprocess_route == "cv2" and str(no_cv2_run["route"]) == "numpy"
    got = tp(frames)
    # the replica route's maps are bit-equal to the cv2 route's
    np.testing.assert_array_equal(no_cv2_run["maps"], got)
    _c5(got, jp(frames), _confident(jp, frames, FRAME_HW))


# -- the overlay ----------------------------------------------------------------


def _scene_classes(hw):
    """A class map with a road, a disconnected road blob, two big cars, a
    tiny car, a sidewalk patch and seeded noise."""
    h, w = hw
    rng = np.random.RandomState(0)
    c = np.zeros((h, w), np.uint8)
    c[h // 2:, w // 5: 4 * w // 5] = 1
    c[h // 2 + 5: h // 2 + 10, 5:15] = 1
    c[h // 4: h // 2, w // 4: w // 4 + 50] = 2
    c[10:14, w // 2: w // 2 + 6] = 2
    c[20:45, 3 * w // 4: 3 * w // 4 + 40] = 2
    c[5:15, 5:25] = 6
    noise = rng.randint(0, 12, (h, w))
    c[noise == 11] = 4
    c[(noise == 10) & (c == 0)] = 1
    return c


OVERLAY_CASES = [(r, b, p, c) for r in (False, True) for b in (False, True)
                 for p in (False, True) for c in (False, True)]


@pytest.mark.parametrize("road_cleanup,car_boxes,precolored,closed", OVERLAY_CASES,
                         ids=lambda v: str(int(v)))
def test_overlay_predictions_matches_jax(demo_frames, road_cleanup, car_boxes, precolored,
                                         closed):
    frame = demo_frames[3]
    classes = _scene_classes(frame.shape[:2])
    closed_road = None
    if closed:
        closed_road = cv2.morphologyEx((classes == 1).astype(np.uint8) * 255,
                                       cv2.MORPH_CLOSE, np.ones((5, 5), np.uint8))
    results = []
    for mod in (post, jax_post):
        kw = dict(road_cleanup=road_cleanup, car_boxes=car_boxes, closed_road=closed_road)
        if precolored:
            kw["precolored_bgr"] = post.COLOR_MAP_BGR[classes].copy()
        results.append(mod.overlay_predictions(frame, classes.copy(), **kw))
    (got, got_det), (want, want_det) = results
    np.testing.assert_array_equal(got, want)
    assert got_det == want_det
    assert got_det["cars"] == (2 if car_boxes else 0)


def test_without_cv2_cleanup_and_blend_run_on_the_native_library(demo_frames, no_cv2_run):
    """cv2 refused: the road cleanup (with and without a device close) and
    the blend go through the native library, bit-equal to the JAX
    package's cv2 route, and car_boxes=True raises naming the flag."""
    assert str(no_cv2_run["lib"]).endswith(".so")
    frame = demo_frames[0]
    classes = _scene_classes(frame.shape[:2])
    closed = cv2.morphologyEx((classes == 1).astype(np.uint8) * 255, cv2.MORPH_CLOSE,
                              np.ones((5, 5), np.uint8))
    np.testing.assert_array_equal(no_cv2_run["cleaned"], jax_post.clean_road_mask(classes))
    np.testing.assert_array_equal(no_cv2_run["cleaned_closed"],
                                  jax_post.clean_road_mask(classes, closed_road=closed))
    for c in (False, True):
        for pre in (False, True):
            want, _ = jax_post.overlay_predictions(
                frame, classes.copy(), car_boxes=False,
                precolored_bgr=post.COLOR_MAP_BGR[classes].copy() if pre else None,
                closed_road=closed if c else None)
            np.testing.assert_array_equal(no_cv2_run[f"overlay_{c}_{pre}"], want)
    assert "--infer.car_boxes=false" in str(no_cv2_run["car_boxes_error"])


def test_without_library_or_cv2_the_postprocess_raises_naming_both(monkeypatch, tmp_path):
    monkeypatch.setattr(native_post, "COMMITTED", tmp_path / "missing.so")
    monkeypatch.setattr(native_post, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    for name, value in (("_TRIED", False), ("_LIB", None), ("_PATH", None), ("_WHY", "")):
        monkeypatch.setattr(native_post, name, value)
    monkeypatch.setattr(post, "cv2_or_none", lambda: None)
    assert not native_post.available() and native_post.library_path() is None
    assert "missing.so" in native_post.unavailable_reason()
    classes = _scene_classes((40, 60))
    with pytest.raises(post.Cv2Missing, match="cv2 or the native"):
        post.clean_road_mask(classes)
    with pytest.raises(post.Cv2Missing, match="cv2 or the native"):
        post.blend(np.zeros((4, 4, 3), np.uint8), np.zeros((4, 4, 3), np.uint8), 0.4)
    with pytest.raises(RuntimeError, match="did not load"):
        native_post.colorize(classes, post.COLOR_MAP_BGR)


def test_native_library_builds_from_source_when_the_committed_one_fails(monkeypatch,
                                                                         tmp_path):
    monkeypatch.setattr(native_post, "COMMITTED", tmp_path / "missing.so")
    monkeypatch.setattr(native_post, "BUILD_DIR", tmp_path / "build")
    for name, value in (("_TRIED", False), ("_LIB", None), ("_PATH", None), ("_WHY", "")):
        monkeypatch.setattr(native_post, name, value)
    path = native_post.library_path()
    assert path is not None and path.startswith(str(tmp_path / "build"))
    classes = _scene_classes((40, 60))
    np.testing.assert_array_equal(native_post.clean_road(classes),
                                  jax_native.clean_road(classes))


# -- native_post against the JAX package's bindings --------------------------------


NATIVE_CASES = ["morph_close", "label_components", "keep_largest", "component_boxes",
                "clean_road", "colorize", "blend", "make_blend_lut", "colorize_blend"]


@pytest.mark.parametrize("name", NATIVE_CASES)
def test_native_post_wrapper_matches_jax(name, demo_frames):
    assert native_post.available() and jax_native.available()
    assert native_post.has_colorize_blend() == jax_native.has_colorize_blend()
    frame = demo_frames[5]
    classes = _scene_classes(frame.shape[:2])
    mask = (classes == 1).astype(np.uint8) * 255
    args = {
        "morph_close": (mask, 5), "label_components": (mask,), "keep_largest": (mask,),
        "component_boxes": ((classes == 2).astype(np.uint8) * 255, 300),
        "clean_road": (classes, 1, 5), "colorize": (classes, post.COLOR_MAP_BGR),
        "blend": (frame, post.COLOR_MAP_BGR[classes], 0.4),
        "make_blend_lut": (post._palette256(), 0.4),
        "colorize_blend": (frame, classes, jax_native.make_blend_lut(post._palette256(), 0.4)),
    }[name]
    got, want = getattr(native_post, name)(*args), getattr(jax_native, name)(*args)
    if isinstance(want, tuple) and not isinstance(want[0], tuple):
        assert got[0] == want[0]
        got, want = got[1], want[1]
    if isinstance(want, list):
        assert got == want and len(want) == 2
    else:
        np.testing.assert_array_equal(got, want)


# -- VideoPipeline -------------------------------------------------------------


def _capture_maps(monkeypatch, module):
    """Record (class map, result, detections) of every overlay_predictions
    call of ``module``'s VideoPipeline."""
    seen = []
    real = (post if module is port_video else jax_post).overlay_predictions

    def spy(frame, classes, **kw):
        result, det = real(frame, classes, **kw)
        seen.append((np.array(classes), result, det))
        return result, det

    monkeypatch.setattr(module, "overlay_predictions", spy)
    return seen


PIPELINE_OPTIONS = {
    "default": dict(),
    "colorize": dict(colorize_on_device=True),
    "fetch_pack4": dict(fetch_pack4=True),
    "device_close": dict(device_close=True, upscale_on_host=False),
    "preprocess_on_host": dict(preprocess_on_host=True),
}


@pytest.mark.parametrize("option", list(PIPELINE_OPTIONS))
def test_video_pipeline_run_matches_jax_and_the_predictor(option, unet_pth, monkeypatch,
                                                          demo_frames):
    kw = dict(checkpoint=unet_pth, input_hw=MODEL_HW, batch_size=4,
              **PIPELINE_OPTIONS[option])
    jp = JaxPredictor(JaxModelConfig(**UNET), **kw)
    tp = Predictor(ModelConfig(**UNET), device="cpu", **kw)
    jax_seen = _capture_maps(monkeypatch, jax_video)
    want = jax_video.VideoPipeline(jp, pipeline_depth=2).run(DEMO, max_frames=10)
    runs = {}
    for depth in (1, 3):
        seen = _capture_maps(monkeypatch, port_video)
        stats = port_video.VideoPipeline(tp, pipeline_depth=depth).run(DEMO, max_frames=10)
        runs[depth] = (stats, seen)
    (stats, seen), (stats3, seen3) = runs[1], runs[3]
    assert sorted(stats) == sorted(want) and sorted(stats["phases"]) == sorted(want["phases"])
    assert stats["frames"] == want["frames"] == stats3["frames"] == len(seen) == 10
    # depth 1 and 3: identical outputs
    for a, b in zip(seen, seen3):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert stats["cars"] == stats3["cars"]
    # per-frame class maps equal to the port's Predictor.__call__ on the batch
    rgb = np.ascontiguousarray(np.stack(demo_frames[:10])[..., ::-1])
    direct = []
    for i in range(0, 10, 4):       # the pipeline's batches, the last one padded
        b = rgb[i:i + 4]
        n = len(b)
        out = tp(np.concatenate([b, np.repeat(b[-1:], 4 - n, 0)]))
        direct.append((out[0] if tp.colorize_on_device else out)[:n])
    direct = np.concatenate(direct)
    if tp.device_close:
        direct = direct & 0x7F
    np.testing.assert_array_equal(np.stack([s[0] for s in seen]), direct)
    # against the JAX pipeline: the C5 rule on the maps, cars where maps agree
    assert len(jax_seen) == 10
    jax_maps = np.stack([s[0] for s in jax_seen])
    confident = np.concatenate([_confident(jp, rgb[i:i + 2], rgb.shape[1:3])
                                for i in range(0, 10, 2)])
    _c5(np.stack([s[0] for s in seen]), jax_maps, confident)
    for (m, _, det), (jm, _, jdet) in zip(seen, jax_seen):
        if np.array_equal(m, jm):
            assert det == jdet


def test_process_frame_and_stream_agree_with_run(unet_pth, monkeypatch, demo_frames,
                                                 tmp_path):
    tp = Predictor(ModelConfig(**UNET), checkpoint=unet_pth, input_hw=MODEL_HW, batch_size=4,
                   device="cpu")
    seen = _capture_maps(monkeypatch, port_video)
    pipe = port_video.VideoPipeline(tp)
    out = str(tmp_path / "out.mp4")
    stats = pipe.run(DEMO, output_path=out, max_frames=5)
    assert stats["frames"] == 5 and stats["fps"] > 0
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    cap.release()
    ran = [s[1] for s in seen]
    del seen[:]
    single = [pipe.process_frame(f) for f in demo_frames[:5]]
    streamed = list(pipe.stream(iter(demo_frames[:5])))
    for r, (a, da), (b, db) in zip(ran, single, streamed):
        np.testing.assert_array_equal(a, r)
        np.testing.assert_array_equal(b, r)
        assert da == db


class _Capture:
    """An in-memory capture with cv2.VideoCapture's read() and get()."""

    def __init__(self, frames):
        self.frames = list(frames)

    def read(self):
        return (True, self.frames.pop(0)) if self.frames else (False, None)

    def get(self, prop):
        return {3: 128.0, 4: 60.0, 5: 30.0}[prop]


def test_run_capture_takes_an_in_memory_capture_and_run_needs_cv2(unet_pth, monkeypatch,
                                                                   frames):
    tp = Predictor(ModelConfig(**UNET), checkpoint=unet_pth, input_hw=MODEL_HW, batch_size=4,
                   device="cpu")
    bgr = [f for f in np.concatenate([frames, frames, frames])[..., ::-1]]
    pipe = port_video.VideoPipeline(tp, car_boxes=False)
    seen = _capture_maps(monkeypatch, port_video)
    stats = pipe._run_capture(_Capture(bgr))
    assert stats["frames"] == 6 and len(seen) == 6
    direct = tp(np.ascontiguousarray(np.stack(bgr[:4])[..., ::-1]))
    np.testing.assert_array_equal(np.stack([s[0] for s in seen[:4]]), direct)
    monkeypatch.setattr(port_video, "cv2_or_none", lambda: None)
    with pytest.raises(RuntimeError, match="A9"):
        pipe.run(DEMO)


# -- the entry point --------------------------------------------------------------


def test_inference_entry_point_prints_the_stats_json(unet_pth):
    out = subprocess.run(
        [sys.executable, "-m", "tpuseg_torch.inference", "--platform=cpu",
         "--model.name=unet", "--model.base_filters=8", "--data.width=64",
         "--data.height=32", f"--infer.checkpoint={unet_pth}", f"--infer.video={DEMO}",
         "--infer.batch_size=4", "--infer.max_frames=8"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["frames"] == 8 and stats["fps"] > 0
    assert sorted(stats) == ["cars", "fps", "fps_ex_fetch", "frames", "phases", "seconds",
                             "tunnel_ok"]


def test_inference_entry_point_needs_a_card_without_the_cpu_flag(monkeypatch):
    from tpuseg_torch import inference

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(["--infer.max_frames=1"])
