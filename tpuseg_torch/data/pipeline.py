"""Host -> device input pipeline: a background batcher and async uploads.

The port of ``tpuseg/data/pipeline.py``. One producer thread assembles
uint8 batches (the sources' decode work) into a bounded queue; the
consumer uploads each batch to the pipeline's device. On a CUDA device the
producer assembles straight into pinned host memory and the upload is
``non_blocking``, so the copy overlaps the step that is running. All
numerical work (normalize, augment) happens on the device
(``tpuseg_torch.data.augment``).

``SampleCache`` is the JAX package's bounded LRU of decoded samples.
Where there is no cache and every picked source has ``load_batch`` (the
packed memmap), a batch is one gather per source, written straight into
the pinned buffer (the native GIL-free memcpy where its library loads):
the same bytes as the per-sample path.

The producer records a ``data.assemble`` span per training batch
(sampling and the gather into the host buffers; ``core/trace.py``) while
the thread that consumes the batches records.
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from tpuseg_torch.core import trace
from tpuseg_torch.data.combined import CombinedDataset, WeightedMixSampler

_STOP = object()


class SampleCache:
    """Bounded LRU cache of decoded samples, keyed by dataset position.

    Exact by construction: the host load path is deterministic per index
    (all randomness happens later on the device), so a hit returns the
    same bytes. ``reserved`` counts non-evictable bytes of the shared
    budget (the eval-batch cache), which eviction cannot reclaim."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self.used = 0
        self.reserved = 0
        self._d: OrderedDict = OrderedDict()

    def get(self, key, loader):
        hit = self._d.get(key)
        if hit is not None:
            self._d.move_to_end(key)
            return hit
        sample = loader()
        if sample is None:  # unreadable: let the caller's redraw logic run
            return None
        size = sum(a.nbytes for a in sample)
        headroom = self.budget - self.reserved
        if size <= headroom:
            while self.used + size > headroom and self._d:
                _, old = self._d.popitem(last=False)
                self.used -= sum(a.nbytes for a in old)
            self._d[key] = sample
            self.used += size
        return sample


def _drain_into(q: queue.Queue, stop: threading.Event, items) -> None:
    """Put each item (then _STOP) on ``q`` unless ``stop`` is set; a full
    queue is retried so that a consumer that left is noticed."""
    for item in items:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                break
            except queue.Full:
                continue
        if stop.is_set():
            return


class InputPipeline:
    """Weighted-mix training batches + deterministic eval batches, yielded
    as (images uint8 [B,H,W,3], masks uint8 [B,H,W]) on ``device``."""

    # consecutive unreadable-sample redraws before giving up
    MAX_REDRAWS = 100

    def __init__(self, combined: CombinedDataset, batch_size: int, height: int,
                 width: int, device: Union[str, torch.device] = "cpu", seed: int = 0,
                 prefetch: int = 2, cache_bytes: int = 0):
        self.combined = combined
        self.sampler = WeightedMixSampler(combined, seed=seed)
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.device = torch.device(device)
        self.prefetch = max(1, prefetch)
        self._cache = SampleCache(cache_bytes) if cache_bytes > 0 else None
        self._eval_cache: Optional[list] = None

    # -- host buffers and upload --------------------------------------------

    def _empty(self, shape) -> torch.Tensor:
        """A uint8 host tensor; pinned (page-locked) when the device is CUDA,
        so that the upload can run asynchronously. The producer writes into
        its ``.numpy()`` view; the tensor itself goes to ``_put``, so that
        the pinned allocator keeps the block until the copy is done."""
        pin = self.device.type == "cuda"
        return torch.empty(shape, dtype=torch.uint8, pin_memory=pin)

    def _put(self, batch) -> Tuple[torch.Tensor, ...]:
        return tuple(x.to(self.device, non_blocking=True) for x in batch)

    # -- training ------------------------------------------------------------

    def _load(self, sid: int, pos: int):
        if self._cache is None:
            return self.combined.load_train(sid, pos)
        return self._cache.get((sid, pos), lambda: self.combined.load_train(sid, pos))

    def _gather(self, picks, imgs: np.ndarray, msks: np.ndarray) -> None:
        """The batched fast path: one ``load_batch`` per source; a single
        source writes straight into the batch buffers."""
        order = np.arange(len(picks))
        sids = np.asarray([sid for sid, _ in picks])
        for sid in np.unique(sids):
            rows = order[sids == sid]
            abs_idx = np.asarray([int(self.combined.train_indices[sid][picks[r][1]])
                                  for r in rows], np.int64)
            source = self.combined.sources[sid]
            if len(rows) == len(imgs):
                source.load_batch(abs_idx, imgs, msks)
            else:
                ti = np.empty((len(rows), *imgs.shape[1:]), np.uint8)
                tm = np.empty((len(rows), *msks.shape[1:]), np.uint8)
                source.load_batch(abs_idx, ti, tm)
                imgs[rows] = ti
                msks[rows] = tm

    def _assemble(self, picks) -> Tuple[torch.Tensor, torch.Tensor]:
        imgs_t = self._empty((self.batch_size, self.height, self.width, 3))
        msks_t = self._empty((self.batch_size, self.height, self.width))
        imgs, msks = imgs_t.numpy(), msks_t.numpy()
        if self._cache is None and all(hasattr(self.combined.sources[sid], "load_batch")
                                       for sid, _ in picks):
            self._gather(picks, imgs, msks)
            return imgs_t, msks_t
        for i, (sid, pos) in enumerate(picks):
            sample = self._load(sid, pos)
            redraws = 0
            while sample is None:  # unreadable file: redraw
                redraws += 1
                if redraws > self.MAX_REDRAWS:
                    raise RuntimeError(
                        f"{self.MAX_REDRAWS} consecutive unreadable samples "
                        "— dataset appears unusable (check paths/permissions)"
                    )
                sid, pos = self.sampler.sample(1)[0]
                sample = self._load(sid, pos)
            imgs[i], msks[i] = sample
        return imgs_t, msks_t

    def _stream(self, produce) -> Iterator:
        """Run generator ``produce()`` on a producer thread through a
        bounded queue and yield its items here. A producer exception is
        re-raised here; leaving early (break, exception) stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        err: list = []

        def producer():
            try:
                _drain_into(q, stop, produce())
            except BaseException as e:  # surface loader crashes, never
                err.append(e)          # swallow them as a clean end
            finally:
                _drain_into(q, stop, [_STOP])

        t = threading.Thread(target=producer, daemon=True, name="tpuseg-torch-loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            t.join(timeout=5)

    def train_batches(self, num_steps: int) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Stream ``num_steps`` device batches drawn by the weighted sampler."""

        spans = trace.follower()     # the producer's spans follow this thread's
        nbytes = self.batch_size * self.height * self.width * 4

        def produce():
            for _ in range(num_steps):
                with spans.span("data.assemble", n=nbytes):
                    batch = self._assemble(self.sampler.sample(self.batch_size))
                yield batch

        for batch in self._stream(produce):
            yield self._put(batch)

    # -- evaluation ----------------------------------------------------------

    def _eval_batches_host(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, int]]:
        n = 0
        for image, mask in self.combined.iter_val():
            if n == 0:
                imgs = self._empty((self.batch_size, self.height, self.width, 3))
                msks = self._empty((self.batch_size, self.height, self.width))
            imgs.numpy()[n], msks.numpy()[n] = image, mask
            n += 1
            if n == self.batch_size:
                yield imgs, msks, n
                n = 0
        if n > 0:
            imgs[n:] = 0
            msks[n:] = 0
            yield imgs, msks, n

    def eval_batches(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, int]]:
        """Deterministic pass over the val split in fixed-size batches; the
        last partial batch is zero-padded and its true count ``n`` yielded.
        With ``cache_bytes``, a full pass that fits the remaining budget is
        kept on the host and replayed by later passes."""
        if self._eval_cache is not None:
            for imgs, msks, n in self._eval_cache:
                yield (*self._put((imgs, msks)), n)
            return
        collect = [] if self._cache is not None else None
        collected = 0
        for imgs, msks, n in self._stream(self._eval_batches_host):
            if collect is not None:
                collected += imgs.nbytes + msks.nbytes
                headroom = self._cache.budget - self._cache.reserved - self._cache.used
                if collected > headroom:
                    collect = None  # val split too big for the budget
                else:
                    collect.append((imgs, msks, n))
            yield (*self._put((imgs, msks)), n)
        if collect is not None:   # only a full, in-budget pass is cached
            self._eval_cache = collect
            self._cache.reserved += collected

    # -- checkpointable state ------------------------------------------------

    def state(self) -> dict:
        return {"sampler": self.sampler.state()}

    def restore(self, state: dict) -> None:
        self.sampler.restore(state["sampler"])
