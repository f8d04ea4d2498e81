"""HTTP serving daemon of the PyTorch port: the Predictor behind a small
stdlib HTTP API, the port of the JAX package's ``tools/serve.py``.

    python -m tpuseg_torch.tools.serve --checkpoint model.pth --port 8017
    python -m tpuseg_torch.tools.serve --platform=cpu --model unet --base_filters 8
    python -m tpuseg_torch.tools.serve --checkpoint model.pth --compute_dtype bfloat16

    curl -s localhost:8017/healthz
    curl -s -X POST -H 'Content-Type: application/octet-stream' -H 'X-Shape: 360,640,3' \
        --data-binary @frame.bgr 'localhost:8017/predict?format=raw' -o mask.u8

It runs on the CUDA card unless ``--platform=cpu`` is given, and raises
without a card otherwise. One process owns the card and one model-size
program: each handler thread downscales its upload to the model size on
the host (cv2 INTER_LINEAR, or its bit-equal numpy replica
``resize_linear_u8_host`` where cv2 does not import), so uploads of any
size share it. One collator thread makes every device call, in arrival
order, and is warmed before the first request: the handler threads never
touch CUDA, so none pays for its own cuDNN and cuBLAS handles, and no
request waits on an unfair lock.

Endpoints:
    GET  /healthz              {"status":"ok", model, input_hw, requests,
                               batching when --max_batch > 1}
    POST /predict              class-id mask at the upload's own size:
                               format=png (default) | raw | json
    POST /overlay              the reference's overlay (road cleanup, car
                               boxes and distance labels, 0.6/0.4 blend),
                               car count in X-Cars: format=png (default) |
                               jpeg[&quality=N] | raw

Raw upload: the pixel bytes with ``Content-Type: application/octet-stream``,
``X-Shape: H,W,3`` and optionally ``X-Pixel-Format: rgb|bgr`` (default
bgr). A raw response is the array's bytes with an X-Shape header. The raw
codec needs no cv2 and is the codec of a host without it; there, png and
jpeg uploads and responses answer 415 with a JSON error naming the missing
codec, and /overlay answers 501 (car boxes need cv2).

Request batching (``--max_batch N --batch_wait_ms W``, off at N=1): the
collator drains concurrent requests for up to W ms, stacks their
model-size inputs, pads to the next power-of-2 bucket (each bucket is
warmed at start, which on the card captures its CUDA graph), dispatches
once and fans the class maps out; a failure
is fanned out to every request of the batch. At N=1 each request is its
own dispatch.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np


def build_predictor(args):
    """Predictor with the serving defaults: batch 1, host preprocess (one
    model-size program for every upload size), host nearest upscale."""
    import torch

    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.core.dtypes import resolve_device
    from tpuseg_torch.infer.predictor import Predictor
    from tpuseg_torch.main import device_for_platform

    device = resolve_device(device_for_platform(getattr(args, "platform", "") or None))
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name=args.model, num_classes=args.num_classes,
                      base_filters=args.base_filters, head_fp32=not args.bf16_head,
                      compute_dtype=args.compute_dtype)
    mean = tuple(float(v) for v in args.normalize_mean.split(",")) \
        if args.normalize_mean else None
    std = tuple(float(v) for v in args.normalize_std.split(",")) \
        if args.normalize_std else None
    return Predictor(cfg, checkpoint=args.checkpoint, artifact=args.artifact,
                     input_hw=(args.height, args.width), batch_size=1,
                     preprocess_on_host=True, upscale_on_host=True,
                     normalize_mean=mean, normalize_std=std, device=device)


class _State:
    """Shared by the handler threads: the predictor, the batcher that makes
    its device calls, and the request counter."""

    def __init__(self, predictor, model_name: str, num_classes: int, batcher):
        self.predictor = predictor
        self.model_name = model_name
        self.num_classes = num_classes
        self.lock = threading.Lock()
        self.requests = 0
        self.batcher = batcher

    def infer_model_sized(self, x):
        """One model-size RGB frame [mh, mw, 3] -> class map [mh, mw]."""
        classes = self.batcher.submit(x)
        with self.lock:
            self.requests += 1
        return classes


class _Batcher:
    """The one thread that calls the device: coalesces concurrent requests
    into one padded dispatch.

    ``submit`` blocks the handler thread until its class map is ready. The
    collator waits up to ``wait_s`` after the first pending request, stacks
    up to ``max_batch`` model-size frames, pads to the next power of 2,
    dispatches once, and fans the results out. With ``warm_hw`` it first
    runs every bucket once on its own thread, and the constructor returns
    when that is done (raising what it raised)."""

    def __init__(self, predictor, max_batch: int, wait_s: float, warm_hw=None):
        self.predictor = predictor
        self.max_batch = int(max_batch)
        self.wait_s = float(wait_s)
        self.q: "queue.Queue" = queue.Queue()
        self.dispatches = 0
        self.max_seen = 0
        warmed, failed = threading.Event(), []
        self._thread = threading.Thread(target=self._run, args=(warm_hw, warmed, failed),
                                        daemon=True, name="tpuseg-serve-batcher")
        self._thread.start()
        warmed.wait()
        if failed:
            raise failed[0]

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _run(self, warm_hw, warmed: threading.Event, failed: list):
        try:
            if warm_hw is not None:
                self._warm_up(warm_hw)
        except Exception as e:  # re-raised by the constructor
            failed.append(e)
            return
        finally:
            warmed.set()
        self._loop()

    def _warm_up(self, input_hw):
        """Run every bucket once before the first client arrives: on the
        card this captures each bucket's CUDA graph, on this thread."""
        h, w = input_hw
        top, b = self._bucket(self.max_batch), 1
        while True:
            self.predictor(np.zeros((b, h, w, 3), np.uint8))
            if b >= top:
                break
            b *= 2

    def submit(self, x):
        done, slot = threading.Event(), {}
        self.q.put((x, done, slot))
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["classes"]

    def close(self):
        """Stop the collator thread (after the server stopped taking requests)."""
        self.q.put(None)
        self._thread.join(timeout=10)

    def _loop(self):
        while True:
            first = self.q.get()
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + self.wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    self.q.put(None)     # close() after this batch
                    break
                batch.append(item)
            n = len(batch)
            # everything that can raise stays inside the try: an escaped
            # exception would end this thread and hang every submit()
            try:
                b = self._bucket(n)
                frames = np.stack([item[0] for item in batch]
                                  + [np.zeros_like(batch[0][0])] * (b - n))
                classes = self.predictor(frames)
                for i, (_, done, slot) in enumerate(batch):
                    slot["classes"] = classes[i]
                    done.set()
            except Exception as e:  # fan the failure out, keep serving
                for _, done, slot in batch:
                    if not done.is_set():
                        slot["error"] = f"{type(e).__name__}: {e}"
                        done.set()
            self.dispatches += 1
            self.max_seen = max(self.max_seen, n)


class _Unsupported(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _codec_missing(what: str) -> _Unsupported:
    return _Unsupported(415, f"{what} needs cv2, which does not import on this host; "
                             "use the raw codec (Content-Type: application/octet-stream "
                             "with X-Shape, and format=raw)")


def _make_handler(state: _State):
    from tpuseg_torch.infer.postprocess import Cv2Missing, cv2_or_none, overlay_predictions
    from tpuseg_torch.infer.predictor import host_resize_linear
    from tpuseg_torch.ops.resize import resize_nearest_host

    cv2 = cv2_or_none()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"   # keep-alive

        def _send(self, code: int, body: bytes, ctype: str, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                return self._send_json(404, {"error": "unknown path"})
            h, w = state.predictor.input_hw
            info = {"status": "ok", "model": state.model_name, "input_hw": [h, w],
                    "requests": state.requests}
            if state.batcher.max_batch > 1:
                info["batching"] = {"max_batch": state.batcher.max_batch,
                                    "wait_ms": state.batcher.wait_s * 1e3,
                                    "dispatches": state.batcher.dispatches,
                                    "max_seen_batch": state.batcher.max_seen}
            self._send_json(200, info)

        def _read_image(self):
            """The upload as a BGR frame, or None when it is not one."""
            length = int(self.headers.get("Content-Length", 0) or 0)
            if length <= 0:
                return None
            raw = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if ctype == "application/octet-stream":
                try:
                    h, w, c = (int(v) for v in self.headers.get("X-Shape", "").split(","))
                except ValueError:
                    return None
                if c != 3 or h <= 0 or w <= 0 or h * w * c != len(raw):
                    return None
                frame = np.frombuffer(raw, np.uint8).reshape(h, w, 3)
                if self.headers.get("X-Pixel-Format", "bgr").lower() == "rgb":
                    frame = frame[..., ::-1]
                return np.ascontiguousarray(frame)
            if cv2 is None:
                raise _codec_missing("decoding an image upload (png, jpeg)")
            return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)

        @staticmethod
        def _check_format(fmt: str) -> None:
            """400 for an unknown response format, 415 for a codec without cv2."""
            if fmt not in ("png", "jpg", "jpeg", "raw"):
                raise _Unsupported(400, f"unknown format {fmt!r}")
            if fmt != "raw" and cv2 is None:
                raise _codec_missing(f"a {fmt} response")

        def _encode(self, img: np.ndarray, fmt: str, quality: int):
            """(bytes, content type, extra headers) of a response image in a
            format ``_check_format`` passed."""
            if fmt == "raw":
                return (np.ascontiguousarray(img).tobytes(), "application/octet-stream",
                        (("X-Shape", ",".join(str(s) for s in img.shape)),))
            if fmt == "png":
                return cv2.imencode(".png", img)[1].tobytes(), "image/png", ()
            return (cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes(),
                    "image/jpeg", ())

        def do_POST(self):
            url = urlparse(self.path)
            if url.path not in ("/predict", "/overlay"):
                return self._send_json(404, {"error": "unknown path"})
            try:
                return self._post(url)
            except _Unsupported as e:
                return self._send_json(e.code, {"error": str(e)})

        def _post(self, url):
            frame_bgr = self._read_image()
            if frame_bgr is None:
                return self._send_json(400, {"error": "body is not a decodable image"})
            # the model takes RGB; the model-size downscale runs here, on
            # this handler thread, so uploads of any size batch together
            rgb = np.ascontiguousarray(frame_bgr[..., ::-1])
            mh, mw = state.predictor.input_hw
            fh, fw = rgb.shape[:2]
            x = host_resize_linear(rgb[None], mh, mw)[0] if (fh, fw) != (mh, mw) else rgb
            try:
                classes = state.infer_model_sized(x)
            except Exception as e:
                # a failure answers 500 with a JSON body, not a dropped connection
                return self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            if classes.shape != (fh, fw):
                classes = resize_nearest_host(classes[None], fh, fw)[0]
            qs = parse_qs(url.query)
            fmt = qs.get("format", ["png"])[0]
            quality = int(qs.get("quality", ["90"])[0])
            if url.path == "/predict":
                if fmt == "json":
                    counts = np.bincount(classes.reshape(-1), minlength=state.num_classes)
                    return self._send_json(200, {"shape": list(classes.shape),
                                                 "class_pixel_counts": counts.tolist()})
                if fmt in ("jpg", "jpeg"):
                    # lossy codecs corrupt class ids
                    return self._send_json(400, {"error": "jpeg is lossy; class masks "
                                                          "support format=png|raw|json"})
                self._check_format(fmt)
                enc = self._encode(classes, fmt, quality)
                return self._send(200, enc[0], enc[1], extra=enc[2])
            self._check_format(fmt)
            try:
                blended, detected = overlay_predictions(frame_bgr, classes)
            except Cv2Missing as e:
                return self._send_json(501, {"error": str(e)})
            enc = self._encode(blended, fmt, quality)
            return self._send(200, enc[0], enc[1],
                              extra=(("X-Cars", str(detected.get("cars", 0))),) + enc[2])

        def log_message(self, fmt, *fmt_args):  # one quiet line per request
            sys.stderr.write("serve: %s %s\n" % (self.command or "?", self.path))

    return Handler


def make_server(args):
    """(httpd, state), warmed up: the first request never builds a kernel
    or plans a convolution."""
    predictor = build_predictor(args)
    batcher = _Batcher(predictor, max(1, getattr(args, "max_batch", 1)),
                       getattr(args, "batch_wait_ms", 5.0) / 1e3, warm_hw=predictor.input_hw)
    state = _State(predictor, args.model, args.num_classes, batcher)
    httpd = ThreadingHTTPServer((args.host, args.port), _make_handler(state))
    return httpd, state


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default="")
    p.add_argument("--artifact", default="")
    p.add_argument("--model", default="mobilenetv2_unet")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--base_filters", type=int, default=0)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--bf16_head", action="store_true")
    p.add_argument("--compute_dtype", default="float32", choices=("float32", "bfloat16"),
                   help="the model's compute dtype (ModelConfig.compute_dtype)")
    p.add_argument("--normalize_mean", default="")
    p.add_argument("--normalize_std", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8017)
    p.add_argument("--max_batch", type=int, default=1,
                   help=">1 coalesces concurrent requests into one device dispatch "
                        "(padded to power-of-2 buckets)")
    p.add_argument("--batch_wait_ms", type=float, default=5.0,
                   help="how long the collator waits for co-travelers after the first "
                        "pending request")
    p.add_argument("--platform", default="",
                   help="cpu runs the plain PyTorch path on the CPU; default: the card")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    httpd, state = make_server(args)
    host, port = httpd.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}", "model": args.model}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        state.batcher.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
