"""The train and eval steps.

The port of ``tpuseg/train/train_step.py``. The JAX package compiles one
program per step and threads an immutable ``TrainState`` through it; here
the state is the model and its optimizer, updated in place, and a step is
eager PyTorch: the forward in train mode (BatchNorm on batch statistics,
running statistics updated as flax does), the loss, the backward, then
``torch.optim.Adam``. Optax's Adam and ``torch.optim.Adam`` compute the
same update (tests/test_torch_parity.py holds them to rtol 1e-9 in f64).

Images enter the steps channels-last ([B, H, W, 3], the JAX layout); the
model sees an NCHW view of them, and the loss the logits' NHWC view.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from tpuseg_torch.data.augment import normalize_images
from tpuseg_torch.train.loss import cross_entropy_loss
from tpuseg_torch.train.metrics import confusion_matrix


def create_optimizer(model: nn.Module, lr: float = 1.5e-4, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    """Adam with torch's defaults, as the reference (Adam(lr=1.5e-4))."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(b1, b2), eps=eps)


def forward_nhwc(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """NHWC images -> NHWC logits (views; no copy under channels_last)."""
    return model(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Optional[Callable] = None,
                    augment_fn: Optional[Callable] = None) -> Callable:
    """The step: ``(images f32 [B,H,W,3], labels [B,H,W]) -> {"loss"}``; or,
    with ``augment_fn``, ``(images u8, masks u8, generator) -> {"loss"}``
    with the augmentation fused in front. ``loss_fn`` defaults to the
    reference's plain cross-entropy. The loss comes back as a detached
    device tensor: reading it is the caller's choice of when to sync. The
    JAX step's remat, EMA, QAT, distillation, bf16-gradient and mesh
    options are not ported; the Trainer refuses their config flags."""
    compute_loss = loss_fn or cross_entropy_loss

    def train_step(images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.train()
        loss = compute_loss(forward_nhwc(model, images), labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    if augment_fn is None:
        return train_step

    def fused_step(images_u8: torch.Tensor, masks_u8: torch.Tensor,
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        x, y = augment_fn(images_u8, masks_u8, generator)
        return train_step(x, y)

    return fused_step


def make_eval_step(model: nn.Module, num_classes: int,
                   normalize: Optional[Tuple] = None, tta: str = "") -> Callable:
    """``(images, labels, n_valid) -> {"loss_sum", "n", "confusion"}``, all
    device tensors, for the first ``n_valid`` samples of the batch (the
    pipeline zero-pads the last one). ``normalize=(mean, std)``: the step
    takes raw uint8 images and normalizes them itself. The per-sample loss
    is the mean over pixels of the CE against a one-hot target, so a label
    outside [0, C) adds 0, as in the JAX package; the confusion matrix
    counts no such pixel. Only ``tta=""`` is ported (A7)."""
    if tta not in ("", "flip", "ms", "flip+ms"):
        raise ValueError(f"unknown tta mode {tta!r} (expected ''|'flip'|'ms'|'flip+ms')")
    if tta:
        raise NotImplementedError(f"eval tta={tta!r} is not ported yet (ROADMAP.md A7, train)")

    @torch.inference_mode()
    def eval_step(images: torch.Tensor, labels: torch.Tensor, n_valid: int):
        images, labels = images[:n_valid], labels[:n_valid].to(torch.int64)
        if normalize is not None:
            images = normalize_images(images, normalize[0], normalize[1])
        was_training = model.training
        model.eval()
        logits = forward_nhwc(model, images).to(torch.float32)
        model.train(was_training)
        logp = torch.log_softmax(logits, dim=-1)
        classes = torch.arange(num_classes, device=logits.device)
        onehot = (labels[..., None] == classes).to(logp.dtype)
        per_sample = -(logp * onehot).sum(-1).mean(dim=(1, 2))
        return {"loss_sum": per_sample.sum(),
                "n": torch.tensor(float(n_valid), device=logits.device),
                "confusion": confusion_matrix(logits.argmax(-1), labels, num_classes)}

    return eval_step
