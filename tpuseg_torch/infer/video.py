"""Batched, pipelined video inference: the port of ``tpuseg/infer/video.py``.

    reader thread:  decode -> lists of BGR frames -> bounded queue
    main thread:    BGR->RGB + batch assembly, ``predict_async`` (resize,
                    normalize, forward, argmax or the colorize kernel),
                    an asynchronous copy of the outputs into pinned host
                    buffers, and the postprocess of the oldest batch in
                    flight while the card runs the newer ones

Only the main thread touches CUDA; the reader thread only reads frames.
The fetch is the counterpart of the JAX package's ``copy_to_host_async``:
each batch's outputs are copied with ``non_blocking=True`` into pinned
tensors and a CUDA event is recorded after the copy; ``flush`` waits on
that event (the ``fetch_wait`` phase) before it reads. ``depth + 1`` sets
of pinned buffers rotate, so no buffer is overwritten while its copy is in
flight or its batch is unread. On the card the outputs are the captured
forward's own tensors, which the next batch's replay overwrites; the copy
is queued on the current stream right after the replay that made them and
before the next one, and stream order keeps it ahead of the overwrite.

``run(video_path)`` opens the file with cv2 (it raises where cv2 does not
import). Everything after the open runs in ``_run_capture``, which takes
any object with ``cv2.VideoCapture``'s ``read()`` and ``get()``.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tpuseg_torch.core import trace
from tpuseg_torch.infer.postprocess import require_cv2, cv2_or_none, overlay_predictions
from tpuseg_torch.infer.predictor import Predictor, host_resize_linear
from tpuseg_torch.ops.kernels import unpack_colors

_STOP = object()
_CAP_PROP_FRAME_WIDTH, _CAP_PROP_FRAME_HEIGHT, _CAP_PROP_FPS = 3, 4, 5


class _PinnedFetch:
    """Device outputs -> host arrays through ``slots`` rotating sets of
    pinned buffers, each copy closed by a CUDA event. On the CPU the
    outputs already are host tensors and pass through."""

    def __init__(self, slots: int):
        self.slots = slots
        self.buffers: List[Optional[List[torch.Tensor]]] = [None] * slots
        self.next = 0

    def start(self, outs):
        outs = outs if isinstance(outs, tuple) else (outs,)
        if outs[0].device.type != "cuda":
            return list(outs), None
        slot, self.next = self.next, (self.next + 1) % self.slots
        bufs = self.buffers[slot]
        if bufs is None or [(b.shape, b.dtype) for b in bufs] != \
                [(t.shape, t.dtype) for t in outs]:
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs]
            self.buffers[slot] = bufs
        # queued before the next replay overwrites ``outs`` (stream order)
        for b, t in zip(bufs, outs):
            b.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return bufs, done

    @staticmethod
    def wait(handle) -> List[np.ndarray]:
        bufs, done = handle
        if done is not None:
            done.synchronize()
        return [b.numpy() for b in bufs]


class VideoPipeline:
    def __init__(
        self,
        predictor: Predictor,
        road_cleanup: bool = True,
        car_boxes: bool = True,
        min_car_area: float = 300.0,
        blend_alpha: float = 0.4,
        pipeline_depth: int = 3,
    ):
        """``pipeline_depth``: batches in flight on the device before the
        host blocks on a fetch. Depth 1 is classic double buffering; the
        oldest batch flushes once ``depth`` newer ones are in flight, so
        ``depth + 1`` undelivered batches (and pinned buffer sets) exist."""
        self.predictor = predictor
        self.pipeline_depth = max(1, pipeline_depth)
        self.post_kwargs = dict(road_cleanup=road_cleanup, car_boxes=car_boxes,
                                min_car_area=min_car_area, blend_alpha=blend_alpha)

    # -- single frame -------------------------------------------------------

    def process_frame(self, frame_bgr: np.ndarray):
        """Frame-serial path, the reference's semantics."""
        rgb = frame_bgr[..., ::-1]
        out = self.predictor(np.ascontiguousarray(rgb[None]))
        if self.predictor.colorize_on_device:
            classes, packed = out
            return overlay_predictions(frame_bgr, classes[0],
                                       precolored_bgr=unpack_colors(packed[0]),
                                       **self.post_kwargs)
        return overlay_predictions(frame_bgr, out[0], **self.post_kwargs)

    def stream(self, frames_bgr: Iterator[np.ndarray]):
        """Generator API: yields (result_frame, detections) per input frame."""
        for frame in frames_bgr:
            yield self.process_frame(frame)

    # -- batched video ------------------------------------------------------

    def _read_batches(self, cap, batch: int, out_q: queue.Queue, max_frames,
                      stop_ev: threading.Event):
        def put(item) -> bool:
            # a bounded put that gives up once the consumer stopped
            while not stop_ev.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        frames, n = [], 0
        while not stop_ev.is_set():
            ok, frame = cap.read()
            if not ok or (max_frames and n >= max_frames):
                break
            frames.append(frame)
            n += 1
            if len(frames) == batch:
                if not put(frames):
                    return
                frames = []
        if frames:
            put(frames)
        put(_STOP)

    def run(self, video_path: str, output_path: str = "", display: bool = False,
            max_frames: Optional[int] = None) -> Dict[str, float]:
        """Process a video file; returns the stats: frames, seconds, fps,
        cars, phases, tunnel_ok, fps_ex_fetch."""
        if cv2_or_none() is None:
            raise RuntimeError("VideoPipeline.run opens the video with cv2.VideoCapture, and cv2 "
                               "does not import on this host (ROADMAP.md: A9, video decode "
                               "without cv2)")
        import cv2

        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video {video_path!r}")
        try:
            return self._run_capture(cap, output_path, display, max_frames)
        finally:
            cap.release()

    def _prepare(self, frames_list):
        """BGR frame list -> contiguous RGB batch (+ true frame hw). With
        preprocess_on_host the downscale runs before the flip (which
        commutes with it), so the flip copies model-size bytes."""
        fh, fw = frames_list[0].shape[:2]
        stacked = np.stack(frames_list)
        if self.predictor.preprocess_on_host:
            stacked = host_resize_linear(stacked, *self.predictor.input_hw)
        return np.ascontiguousarray(stacked[..., ::-1]), (fh, fw)

    def _run_capture(self, cap, output_path: str = "", display: bool = False,
                     max_frames: Optional[int] = None) -> Dict[str, float]:
        """The pipeline on an opened capture (``read()`` and ``get()``)."""
        writer = None
        if output_path:
            cv2 = require_cv2("writing the output video")
            fps_src = cap.get(_CAP_PROP_FPS) or 30.0
            w, h = int(cap.get(_CAP_PROP_FRAME_WIDTH)), int(cap.get(_CAP_PROP_FRAME_HEIGHT))
            writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps_src,
                                     (w, h))
        if display:
            require_cv2("display")
        pred = self.predictor
        batch = pred.batch_size
        q_in: queue.Queue = queue.Queue(maxsize=2)
        stop_reading = threading.Event()
        reader = threading.Thread(target=self._read_batches,
                                  args=(cap, batch, q_in, max_frames, stop_reading),
                                  daemon=True, name="tpuseg-video-reader")
        reader.start()
        fetch = _PinnedFetch(self.pipeline_depth + 1)
        stats = {"frames": 0, "cars": 0}
        # Phase attribution (seconds): decode_wait is time blocked on the
        # reader, fetch_wait the wait for the device and its copy to host,
        # post the host postprocess, write the output encode; each a
        # ``video.<phase>`` span when the recorder records
        phases = trace.Totals("video", ("decode_wait", "fetch_wait", "post", "write"))
        pending = deque()   # (frames_bgr, fetch handle, n_valid) in flight
        colorized = pred.colorize_on_device

        def flush(entry) -> bool:
            frames_bgr, handle, n_valid = entry
            with phases.span("fetch_wait"):
                host = fetch.wait(handle)
            with phases.span("post"):
                out = pred.finish_host(host[0], host[1] if colorized else None,
                                       *frames_bgr[0].shape[:2])
                classes, packed = out if colorized else (out, None)
                closed = None
                if pred.device_close:
                    # the device packed the road close into bit 0x80
                    closed = classes >= 0x80
                    classes = classes & 0x7F
            for i in range(n_valid):
                with phases.span("post"):
                    result, det = overlay_predictions(
                        frames_bgr[i], classes[i],
                        precolored_bgr=unpack_colors(packed[i]) if colorized else None,
                        closed_road=closed[i] if closed is not None else None,
                        **self.post_kwargs)
                stats["frames"] += 1
                stats["cars"] += det["cars"]
                if writer is not None:
                    with phases.span("write"):
                        writer.write(result)
                if display:
                    import cv2

                    cv2.imshow("tpuseg", result)
                    if cv2.waitKey(1) & 0xFF == ord("q"):
                        return True
            return False

        try:
            # Warm-up before the clock: the first batch, prepared exactly as
            # the steady ones (first kernel builds, cuDNN plans), then fetched.
            first = q_in.get()
            if first is not _STOP:
                rgb0, fhw0 = self._prepare(first + [first[-1]] * (batch - len(first)))
                _PinnedFetch.wait(fetch.start(pred.predict_async(rgb0, out_hw=fhw0)))
            t0 = time.time_ns()
            item, stop = first, False
            while item is not _STOP:
                frames_bgr = item
                n_valid = len(frames_bgr)
                if n_valid < batch:   # pad the last batch to keep shapes static
                    frames_bgr = frames_bgr + [frames_bgr[-1]] * (batch - n_valid)
                rgb, fhw = self._prepare(frames_bgr)
                handle = fetch.start(pred.predict_async(rgb, out_hw=fhw))
                pending.append((frames_bgr, handle, n_valid))
                # flush the oldest once `depth` newer batches are in flight
                if len(pending) > self.pipeline_depth:
                    stop = flush(pending.popleft())
                if stop:
                    break
                with phases.span("decode_wait"):
                    item = q_in.get()
            while pending and not stop:
                stop = flush(pending.popleft())
            # the clock (the phases' own) stops before the teardown
            dt = (time.time_ns() - t0) * 1e-9
        finally:
            stop_reading.set()
            reader.join(timeout=5)
            if writer is not None:
                writer.release()
            if display:
                import cv2

                cv2.destroyAllWindows()
        stats["seconds"] = dt
        stats["fps"] = stats["frames"] / dt if dt > 0 else 0.0
        seconds = phases.seconds
        stats["phases"] = {k: round(v, 3) for k, v in seconds.items()}
        # the fetch is hidden when its wait is a small share of the run; a
        # run where it is not says more about the transfer than the pipeline
        stats["tunnel_ok"] = seconds["fetch_wait"] <= max(0.05 * dt, 0.05)
        stats["fps_ex_fetch"] = stats["frames"] / max(dt - seconds["fetch_wait"], 1e-6)
        return stats
