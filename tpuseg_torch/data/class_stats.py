"""Per-class pixel statistics and class-weight suggestion.

The port of ``tpuseg/data/class_stats.py`` (numpy only; a copy, the port
imports nothing of the JAX package). The shared implementation behind:

- ``python -m tpuseg_torch.tools.class_stats``, the offline CLI (prints
  counts and a flag line);
- ``--train.class_weights=auto`` / ``auto:median`` / ``auto:inverse``: the
  Trainer resolves the weights at startup by scanning the TRAIN split of
  its own CombinedDataset (never the val split), combining per-source
  frequencies with the sampler's mix probabilities, so the estimate
  matches the stream the loss will see.

Host-side only: the scan reads through the sources' ``load``, the path
training reads through; nothing here touches the device.
"""

from __future__ import annotations

import logging
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)


def mask_class_counts(
    masks: Iterable[np.ndarray], num_classes: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Accumulate per-class pixel and image-presence counts over ``masks``.

    Values >= num_classes (e.g. an ignore_index of 255) are excluded —
    they contribute to no class, matching the loss's ignore semantics.
    Returns (pixel_counts[C], images_present[C], images_read).
    """
    counts = np.zeros(num_classes, np.int64)
    present = np.zeros(num_classes, np.int64)
    read = 0
    for mask in masks:
        c = np.bincount(
            np.asarray(mask, np.int64).ravel(), minlength=num_classes
        )[:num_classes]
        counts += c
        present += (c > 0).astype(np.int64)
        read += 1
    return counts, present, read


def compute_stats(source, num_classes: int, samples: int = 0):
    """Walk ``source.load`` (whole source) and accumulate class counts.

    ``samples`` caps the number of images scanned (0 = all). Unreadable
    samples (load() -> None) are skipped, like the training pipeline does.
    """
    n = len(source)
    if samples:
        n = min(n, samples)

    def _masks():
        for i in range(n):
            item = source.load(i)
            if item is None:
                continue
            yield item[1]

    return mask_class_counts(_masks(), num_classes)


def suggest_weights(
    counts: np.ndarray, scheme: str = "median"
) -> np.ndarray:
    """Weights for --train.class_weights from per-class pixel counts (or
    frequencies — only ratios matter). Absent classes get 0: their CE
    contribution is empty anyway, and 0 keeps them out of the smoothing
    term's per-class sum.

    - "median": median-frequency balancing (Eigen & Fergus):
      w_c = median(freq)/freq_c over present classes.
    - "inverse": plain 1/freq_c normalized to mean 1 over present classes.
    """
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    freq = counts / max(total, 1e-12)
    present = counts > 0
    w = np.zeros_like(freq)
    if not present.any():
        return w
    if scheme == "median":
        med = np.median(freq[present])
        w[present] = med / freq[present]
    elif scheme == "inverse":
        w[present] = 1.0 / freq[present]
        w[present] /= w[present].mean()
    else:
        raise ValueError(f"unknown class-weight scheme {scheme!r}")
    return w


def stream_class_frequencies(
    combined, num_classes: int, samples_per_source: int = 256
) -> np.ndarray:
    """Expected per-pixel class distribution of the TRAIN stream.

    Scans up to ``samples_per_source`` images from each source's train
    split and combines per-source frequencies with the mix weights
    (renormalized over non-empty train splits) — the same probabilities
    the WeightedSampler draws sources with, so the estimate matches what
    the loss will actually see. Returns freq[C] summing to ~1.
    """
    probs = np.asarray(
        [
            w if len(idx) else 0.0
            for w, idx in zip(combined.weights, combined.train_indices)
        ],
        np.float64,
    )
    if probs.sum() <= 0:
        raise ValueError("no non-empty train splits to scan")
    probs = probs / probs.sum()

    freq = np.zeros(num_classes, np.float64)
    for sid, (p, idx) in enumerate(zip(probs, combined.train_indices)):
        if p == 0.0:
            continue
        n = min(len(idx), samples_per_source)

        def _masks():
            for pos in range(n):
                item = combined.load_train(sid, pos)
                if item is None:
                    continue
                yield item[1]

        counts, _, read = mask_class_counts(_masks(), num_classes)
        if read == 0:
            raise ValueError(
                f"source {sid}: no readable train samples to scan for "
                "auto class weights"
            )
        freq += p * counts / max(counts.sum(), 1e-12)
    return freq


def resolve_auto_class_weights(
    combined,
    num_classes: int,
    spec: str = "auto",
    samples_per_source: int = 256,
) -> Tuple[float, ...]:
    """Resolve ``--train.class_weights=auto[:scheme]`` against a
    CombinedDataset's train split. Returns a [C] float tuple.

    ``spec`` is "auto" (median-frequency) or "auto:median"/"auto:inverse".
    """
    head, _, scheme = spec.partition(":")
    if head != "auto":
        raise ValueError(
            f"class_weights string must be 'auto' or 'auto:<scheme>', got "
            f"{spec!r}"
        )
    scheme = scheme or "median"
    freq = stream_class_frequencies(
        combined, num_classes, samples_per_source=samples_per_source
    )
    w = suggest_weights(freq, scheme)
    log.info(
        "auto class_weights (%s, %d samples/source): %s",
        scheme,
        samples_per_source,
        [round(float(x), 4) for x in w],
    )
    return tuple(float(x) for x in w)
