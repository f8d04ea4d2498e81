"""The port's HTTP server (``tpuseg_torch.tools.serve``) at ``device="cpu"``.

The cases of the JAX package's ``tests/test_serve.py``, through real HTTP
on an ephemeral port: healthz, raw and png codecs, json counts, batching,
errors, one model-size program for every upload size; then the host
without cv2 (png and jpeg answer 415, /overlay 501, the raw codec serves
the same masks through the numpy resize replica), and the class maps
against the JAX server on the same weights. Those follow the C5 rule
(ROADMAP.md): >= 99.9% agreement, and equality where JAX's top-two logit
margin exceeds 1e-3. Every other comparison is bit-equal.
"""

import argparse
import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.data.augment import normalize_images as jax_normalize
from tpuseg.ops.resize import resize_nearest as jax_nearest
from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core.prng import make_generator
from tpuseg_torch.core.weights import init_weights
from tpuseg_torch.infer import postprocess, predictor as port_predictor
from tpuseg_torch.models.blocks import Conv2d
from tpuseg_torch.models.registry import build_model
from tpuseg_torch.tools import serve

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARGIN = 1e-3


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """Seeded UNet (base_filters 8) weights with random BatchNorm
    statistics, the head's road and car biases raised so both show."""
    model = build_model(ModelConfig(name="unet", base_filters=8))
    init_weights(model, make_generator(0), random_bn=True)
    sd = model.state_dict()
    sd["sem_out.conv.3.bias"][1] += 5.0
    sd["sem_out.conv.3.bias"][2] += 4.0
    path = tmp_path_factory.mktemp("serve") / "unet.pth"
    torch.save(sd, path)
    return str(path)


def _args(pth, **kw):
    ns = serve.parse_args(["--model", "unet", "--base_filters", "8", "--width", "64",
                           "--height", "32", "--port", "0", "--platform", "cpu",
                           "--checkpoint", pth])
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _start(make_server, args):
    httpd, state = make_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address[:2]
    return f"http://{host}:{port}", state, httpd, thread


def _stop(httpd, thread, state=None):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    if state is not None and hasattr(state.batcher, "close"):    # the port's server
        state.batcher.close()


@pytest.fixture(scope="module")
def server(pth):
    base, state, httpd, thread = _start(serve.make_server, _args(pth))
    yield base, state
    _stop(httpd, thread, state)


@pytest.fixture(scope="module")
def batched_server(pth):
    # a wide window, so that four concurrent posts coalesce however far
    # apart the threads are scheduled (it costs nothing once all 4 arrive)
    base, state, httpd, thread = _start(serve.make_server,
                                        _args(pth, max_batch=4, batch_wait_ms=2000.0))
    yield base, state
    _stop(httpd, thread, state)


def _frame(seed=0, h=48, w=80):
    return np.random.default_rng(seed).integers(0, 255, size=(h, w, 3), dtype=np.uint8)


def _png(frame_bgr):
    ok, png = cv2.imencode(".png", frame_bgr)
    assert ok
    return png.tobytes()


def _raw_headers(frame, fmt="bgr"):
    h, w = frame.shape[:2]
    return {"Content-Type": "application/octet-stream", "X-Shape": f"{h},{w},3",
            "X-Pixel-Format": fmt}


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, headers=headers or {})
    return urllib.request.urlopen(req, timeout=120)


def _read_raw(r):
    shape = tuple(int(v) for v in r.headers["X-Shape"].split(","))
    return np.frombuffer(r.read(), np.uint8).reshape(shape)


def _direct(state, frame_bgr):
    return state.predictor(np.ascontiguousarray(frame_bgr[..., ::-1])[None])[0]


def test_healthz(server):
    base, _ = server
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        assert r.status == 200
        info = json.loads(r.read())
    assert info["status"] == "ok" and info["input_hw"] == [32, 64] and info["model"] == "unet"
    assert "batching" not in info


def test_raw_upload_and_raw_response(server):
    base, state = server
    frame = _frame(seed=11)
    with _post(base + "/predict?format=raw", frame.tobytes(), _raw_headers(frame)) as r:
        assert r.headers["Content-Type"] == "application/octet-stream"
        mask = _read_raw(r)
    np.testing.assert_array_equal(mask, _direct(state, frame))
    assert len(np.unique(mask)) >= 2
    rgb = frame[..., ::-1].copy()
    with _post(base + "/predict?format=raw", rgb.tobytes(), _raw_headers(frame, "rgb")) as r:
        np.testing.assert_array_equal(_read_raw(r), mask)
    with _post(base + "/predict", _png(frame)) as r:
        assert r.headers["Content-Type"] == "image/png"
        png_mask = cv2.imdecode(np.frombuffer(r.read(), np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(png_mask, mask)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/predict", frame.tobytes(),
              dict(_raw_headers(frame), **{"X-Shape": "nope"}))
    assert e.value.code == 400


def test_compute_dtype_bfloat16_serves_a_bf16_model(pth):
    """``--compute_dtype bfloat16``: every conv of the served model computes
    in bf16, and the raw masks are those of a bf16 Predictor built on its
    own from the same weights."""
    args = serve.parse_args(["--model", "unet", "--base_filters", "8", "--width", "64",
                             "--height", "32", "--port", "0", "--platform", "cpu",
                             "--checkpoint", pth, "--compute_dtype", "bfloat16"])
    base, state, httpd, thread = _start(serve.make_server, args)
    try:
        frame = _frame(seed=41, h=60, w=128)
        with _post(base + "/predict?format=raw", frame.tobytes(), _raw_headers(frame)) as r:
            mask = _read_raw(r)
    finally:
        _stop(httpd, thread, state)
    convs = [m for m in state.predictor.model.modules() if isinstance(m, Conv2d)]
    assert convs and {m.compute_dtype for m in convs} == {torch.bfloat16}
    ref = port_predictor.Predictor(
        ModelConfig(name="unet", base_filters=8, compute_dtype="bfloat16"), checkpoint=pth,
        input_hw=(32, 64), batch_size=1, preprocess_on_host=True, device="cpu")
    np.testing.assert_array_equal(mask, ref(np.ascontiguousarray(frame[..., ::-1])[None])[0])
    assert len(np.unique(mask)) >= 2


def test_predict_json_counts(server):
    base, state = server
    frame = _frame(seed=2)
    with _post(base + "/predict?format=json", _png(frame)) as r:
        out = json.loads(r.read())
    assert out["shape"] == list(frame.shape[:2])
    assert out["class_pixel_counts"] == np.bincount(_direct(state, frame).ravel(),
                                                    minlength=10).tolist()


def test_overlay_formats_and_car_header(server):
    base, state = server
    frame = _frame(seed=3, h=120, w=200)
    want, det = postprocess.overlay_predictions(frame, _direct(state, frame))
    with _post(base + "/overlay?format=raw", _png(frame)) as r:
        assert int(r.headers["X-Cars"]) == det["cars"]
        np.testing.assert_array_equal(_read_raw(r), want)
    with _post(base + "/overlay", _png(frame)) as r:
        assert r.headers["Content-Type"] == "image/png"
        np.testing.assert_array_equal(
            cv2.imdecode(np.frombuffer(r.read(), np.uint8), cv2.IMREAD_COLOR), want)
    with _post(base + "/overlay?format=jpeg&quality=80", _png(frame)) as r:
        assert r.headers["Content-Type"] == "image/jpeg"
        assert cv2.imdecode(np.frombuffer(r.read(), np.uint8), cv2.IMREAD_COLOR).shape == \
            frame.shape
    for url in ("/predict?format=jpeg", "/overlay?format=bmp"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + url, _png(frame))
        assert e.value.code == 400


def test_bad_body_and_unknown_path(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/predict", b"this is not an image")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/nope", b"x")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/predict", timeout=60)   # GET
    assert e.value.code == 404


def test_any_upload_size_runs_one_model_size_program(server, monkeypatch):
    """The handler downscales on the host, so the device forward only ever
    sees model-size frames, whatever the upload size."""
    base, state = server
    shapes = []
    real = state.predictor._device_forward

    def spy(x, out_hw):
        shapes.append((tuple(x.shape[1:3]), tuple(out_hw)))
        return real(x, out_hw)

    monkeypatch.setattr(state.predictor, "_device_forward", spy)
    for seed, (h, w) in ((4, (30, 50)), (5, (100, 160)), (6, (32, 64))):
        frame = _frame(seed=seed, h=h, w=w)
        with _post(base + "/predict?format=raw", frame.tobytes(), _raw_headers(frame)) as r:
            assert _read_raw(r).shape == (h, w)
    assert shapes == [((32, 64), (32, 64))] * 3


def test_unbatched_predictor_failure_returns_500_json(server, monkeypatch):
    base, state = server
    frame = _frame(seed=9)

    def boom(x):
        raise ValueError("synthetic predictor failure")

    monkeypatch.setattr(state, "infer_model_sized", boom)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/predict", _png(frame))
    assert e.value.code == 500
    body = json.loads(e.value.read())
    assert "ValueError" in body["error"] and "synthetic predictor failure" in body["error"]
    monkeypatch.undo()
    with _post(base + "/predict", _png(frame)) as r:
        assert r.status == 200


def test_batched_requests_coalesce_and_match_direct(batched_server):
    base, state = batched_server
    frames = [_frame(seed=10 + i, h=40 + 8 * i, w=64 + 16 * i) for i in range(4)]
    results = [None] * 4

    def post(i):
        with _post(base + "/predict?format=raw", frames[i].tobytes(),
                   _raw_headers(frames[i])) as r:
            results[i] = _read_raw(r)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for frame, got in zip(frames, results):
        assert got is not None and got.shape == frame.shape[:2]
        np.testing.assert_array_equal(got, _direct(state, frame))
    assert state.batcher.max_seen >= 2 and state.batcher.dispatches < 4 + 1
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        info = json.loads(r.read())
    assert info["batching"]["max_batch"] == 4 and info["batching"]["dispatches"] >= 1


def test_batcher_fans_a_failure_out_to_every_request(pth):
    class Failing:
        def __call__(self, frames):
            raise RuntimeError("device lost")

    b = serve._Batcher(Failing(), max_batch=2, wait_s=0.5)
    errors = []

    def submit():
        try:
            b.submit(np.zeros((32, 64, 3), np.uint8))
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=submit) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    b.close()
    assert errors == ["RuntimeError: device lost"] * 2
    assert not b._thread.is_alive()


def test_every_device_call_runs_on_the_warmed_collator_thread(pth, monkeypatch):
    """The handler threads never call the device: the warm-up and each
    request's dispatch run on the collator thread, and a warm-up failure
    is raised by the constructor."""
    from tpuseg_torch.infer.predictor import Predictor

    threads = []
    real = Predictor.__call__

    def spy(self, frames):
        threads.append(threading.current_thread().name)
        return real(self, frames)

    monkeypatch.setattr(Predictor, "__call__", spy)
    base, state, httpd, thread = _start(serve.make_server, _args(pth))
    try:
        assert threads == ["tpuseg-serve-batcher"]
        frame = _frame(seed=41)
        with _post(base + "/predict?format=raw", frame.tobytes(), _raw_headers(frame)) as r:
            assert r.status == 200
    finally:
        _stop(httpd, thread, state)
    assert threads == ["tpuseg-serve-batcher"] * 2

    class Failing:
        def __call__(self, frames):
            raise RuntimeError("no device")

    with pytest.raises(RuntimeError, match="no device"):
        serve._Batcher(Failing(), max_batch=1, wait_s=0.0, warm_hw=(32, 64))


@pytest.fixture
def no_cv2_server(pth, monkeypatch):
    """The port's server as a host without cv2 builds it (cv2_or_none -> None)."""
    monkeypatch.setattr(postprocess, "cv2_or_none", lambda: None)
    monkeypatch.setattr(port_predictor, "cv2_or_none", lambda: None)
    base, state, httpd, thread = _start(serve.make_server, _args(pth))
    yield base, state
    _stop(httpd, thread, state)


def test_without_cv2_png_and_jpeg_answer_415_and_raw_serves_the_same_masks(no_cv2_server,
                                                                           server):
    base, state = no_cv2_server
    frame = _frame(seed=21, h=90, w=150)
    for url, body, headers in (("/predict?format=raw", _png(frame), {}),
                               ("/predict", frame.tobytes(), _raw_headers(frame)),
                               ("/overlay?format=jpeg", frame.tobytes(), _raw_headers(frame))):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + url, body, headers)
        assert e.value.code == 415
        assert "cv2" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/overlay?format=raw", frame.tobytes(), _raw_headers(frame))
    assert e.value.code == 501 and "car_boxes" in json.loads(e.value.read())["error"]
    with _post(base + "/predict?format=raw", frame.tobytes(), _raw_headers(frame)) as r:
        got = _read_raw(r)
    # the numpy resize replica feeds the model the same bytes as cv2
    with _post(server[0] + "/predict?format=raw", frame.tobytes(), _raw_headers(frame)) as r:
        np.testing.assert_array_equal(got, _read_raw(r))


def _load_jax_serve():
    spec = importlib.util.spec_from_file_location("tpuseg_tool_serve_jax",
                                                  os.path.join(ROOT, "tools", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_class_maps_match_the_jax_server_on_the_same_weights(server, pth):
    jax_serve = _load_jax_serve()
    ns = argparse.Namespace(**vars(_args(pth)))
    ns.platform = ""
    jbase, jstate, httpd, thread = _start(jax_serve.make_server, ns)
    try:
        base, _ = server
        for seed, (h, w) in ((31, (60, 128)), (32, (90, 150)), (33, (32, 64))):
            frame = _frame(seed=seed, h=h, w=w)
            masks = []
            for url in (base, jbase):
                with _post(url + "/predict?format=raw", frame.tobytes(),
                           _raw_headers(frame)) as r:
                    masks.append(_read_raw(r))
            got, want = masks
            # JAX's top-two margins on the model input both servers build
            jp = jstate.predictor
            x = cv2.resize(np.ascontiguousarray(frame[..., ::-1]), (64, 32),
                           interpolation=cv2.INTER_LINEAR)
            x = jax_normalize(jnp.asarray(x[None], jnp.float32), jp.normalize_mean,
                              jp.normalize_std)
            logits = np.asarray(jp.model.apply(jp.variables, x, train=False))
            top2 = np.sort(logits, axis=-1)[..., -2:]
            margin = jnp.asarray((top2[..., 1] - top2[..., 0]).astype(np.float32))
            confident = np.asarray(jax_nearest(margin, h, w))[0] > MARGIN
            same = got == want
            assert same.mean() >= 0.999 and same[confident].all()
            assert len(np.unique(want)) >= 2
    finally:
        _stop(httpd, thread)
