"""Segmentation metrics: confusion matrix, per-class IoU, mIoU, pixel accuracy.

The port of ``tpuseg/train/metrics.py``. The confusion matrix is counted
on the device with one ``scatter_add_`` of ones at ``target * C + pred``
into C*C + 1 int64 counters (the JAX package used a one-hot matmul
because the TPU has no fast scatter); a pixel whose target or prediction
lies outside ``[0, C)`` goes to the last counter, which is dropped, as a
one-hot of an out-of-range index is all zero there. The shapes do not
depend on the data and nothing is read back to the host, so a captured
eval step holds it. The derived metrics run on the host in numpy, with
NaN for classes absent from both.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(preds: torch.Tensor, targets: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """[C, C] int64 counts, rows = target class, cols = predicted class."""
    t = targets.reshape(-1).to(torch.int64)
    p = preds.reshape(-1).to(torch.int64)
    keep = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    dump = num_classes * num_classes
    idx = torch.where(keep, t * num_classes + p, dump)
    flat = torch.zeros(dump + 1, dtype=torch.int64, device=t.device)
    flat.scatter_add_(0, idx, torch.ones_like(idx))
    return flat[:dump].view(num_classes, num_classes)


def iou_from_confusion(cm) -> np.ndarray:
    """Per-class IoU; classes absent from both pred and target get NaN."""
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diag(cm)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    denom = tp + fp + fn
    return np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)


def mean_iou(cm) -> float:
    """mIoU over classes present in the data (NaN classes excluded)."""
    iou = iou_from_confusion(cm)
    if np.isnan(iou).all():
        return float("nan")
    return float(np.nanmean(iou))


def pixel_accuracy_from_confusion(cm) -> float:
    cm = np.asarray(cm, dtype=np.float64)
    return float(np.diag(cm).sum() / max(cm.sum(), 1))
