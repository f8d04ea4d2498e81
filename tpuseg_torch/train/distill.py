"""Knowledge distillation: soft-target training against a frozen teacher.

The port of ``tpuseg/train/distill.py`` (Hinton et al., "Distilling the
Knowledge in a Neural Network"): per-pixel KL between the
temperature-softened teacher and student distributions, scaled by T^2,

    loss = (1 - alpha) * base_loss(student, labels)
         + alpha * T^2 * mean_px KL( softmax(t/T) || softmax(s/T) )

in at least float32. The KL form (not soft cross-entropy) gives exactly 0
when teacher and student agree. The teacher forward runs inside the train
step (``train/train_step.py``), before the student's loss and outside
autograd; on the card it is part of the captured step, the teacher's
parameters and buffers static tensors of the graph.

Over a mesh (``mesh``, its data axis; the whole mesh with ``spatial``,
where each rank holds an H-slab) the KD mean is the global batch's: its
sum and count are all-reduced with the other losses' global sums
(``train/loss.py``'s convention).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from tpuseg_torch.train.loss import _global


def _kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor, t: float) -> torch.Tensor:
    """Per-pixel KL(softmax(teacher/T) || softmax(student/T)), [B, H, W]."""
    dtype = torch.promote_types(student_logits.dtype, torch.float32)
    slp = torch.log_softmax(student_logits.to(dtype) / t, dim=-1)
    tlp = torch.log_softmax(teacher_logits.to(dtype) / t, dim=-1)
    return torch.sum(torch.exp(tlp) * (tlp - slp), dim=-1)


def kd_kl_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               temperature: float = 2.0, mesh=None, spatial: bool = False) -> torch.Tensor:
    """Mean per-pixel T^2 * KL(softmax(teacher/T) || softmax(student/T)) of
    [B, H, W, C] logits (the global batch's over ``mesh``)."""
    t = float(temperature)
    kl = _kl(student_logits, teacher_logits, t)
    if mesh is None:
        return torch.mean(kl) * (t * t)
    num, den = _global(mesh, spatial, torch.sum(kl), kl.new_full((), kl.numel()))
    return (num / den) * (t * t)


def make_distill_loss(base_loss: Callable, alpha: float, temperature: float,
                      ignore_index: int = -1, mesh=None, spatial: bool = False) -> Callable:
    """(student_logits, labels, teacher_logits) -> the combined loss.

    ``alpha`` in (0, 1], else ValueError; 1 skips the base loss.
    ``ignore_index`` >= 0 leaves those label pixels out of the KD mean too
    (divided by max(valid pixels, 1))."""
    a = float(alpha)
    if not 0.0 < a <= 1.0:
        raise ValueError(f"distill alpha must be in (0, 1], got {a}")
    t = float(temperature)

    def loss(logits, labels, teacher_logits):
        if ignore_index >= 0:
            kl = _kl(logits, teacher_logits, t)
            valid = (labels != ignore_index).to(kl.dtype)
            num, den = _global(mesh, spatial, torch.sum(kl * valid), torch.sum(valid))
            kd = (num / torch.clamp(den, min=1.0)) * (t * t)
        else:
            kd = kd_kl_loss(logits, teacher_logits, t, mesh, spatial)
        if a >= 1.0:
            return kd
        return (1.0 - a) * base_loss(logits, labels) + a * kd

    return loss


def make_teacher_fn(model: nn.Module) -> Callable:
    """The frozen teacher's forward for the train step: NHWC images ->
    NHWC logits, in eval mode (BatchNorm on its running statistics), with
    no autograd graph. ``model`` is the teacher alone: it shares no mesh,
    train mode or QAT marker with the student."""
    model.eval().requires_grad_(False)

    def teacher_fn(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    return teacher_fn
