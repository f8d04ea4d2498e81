"""The train and eval steps.

The port of ``tpuseg/train/train_step.py``. The JAX package compiles one
program per step and threads an immutable ``TrainState`` through it; here
the state is the model and its ``Optimizer`` (``train/optim.py``, optax's
formulas), updated in place, and a step on the card is a replay of a
captured CUDA graph (``core/graphs.py``): augment, forward in train mode
(BatchNorm on batch statistics, running statistics moved as flax moves
them), loss, backward, clip, update and EMA, all in one graph. On the CPU,
or inside ``graphs.eager()``, the same body runs op by op. ``grads_bf16``
casts the gradients to bf16 between the backward and the update, as the
JAX step does (over a mesh, after their all_reduce in fp32, as JAX's psum
inside the gradient comes before its cast).

Images enter the steps channels-last ([B, H, W, 3], the JAX layout); the
model sees an NCHW view of them, and the loss the logits' NHWC view.

Distillation (``teacher_fn``, ``train/distill.py``): the frozen teacher's
forward runs inside the step, on the augmented images (this rank's rows
over a mesh), before the student's forward and outside autograd; the loss
is then called as ``(logits, labels, teacher_logits)``. On the card it is
part of the captured graph. QAT needs nothing here: the marked convs
quantize in train mode (``ops/fake_quant.py``).

Over a mesh (``mesh``, more than one rank; ``tpuseg_torch.core.mesh``) a
step is one global step, as the JAX package's data-sharded jit is: every
rank is given the same global batch, augments all of it with the same
draws, and keeps its rows (``batch_slice``); the loss (``make_loss_fn``
with the mesh) and the BatchNorm statistics (``blocks.set_mesh``) are the
global batch's; ONE all_reduce sums the flattened parameter gradients
(``Optimizer.sum_grads``); then the clip on the global norm, the update
and the EMA run alike on every rank, so the parameters stay equal there.
Such a step runs uncaptured: its collectives sync the host with the card
(gloo stages through host memory), which a CUDA graph cannot hold. The
eval step evaluates this rank's rows and sums its outputs over the ranks.

``spatial`` (a mesh with a spatial axis above one; the JAX step's
``spatial=True``) also splits the image height over the mesh's "spatial"
axis after the augment: each rank keeps its rows and its H-slab
(``batch_slice(..., spatial_dim=1)``, the counterpart of
``_spatial_constraint``) and runs the forward and the backward in the
spatial mode (``tpuseg_torch/parallel/spatial.py``), where every layer
computes its owned rows and fetches the rows it reads from their owners,
as GSPMD's halo exchanges do. BatchNorm statistics, the loss's sums and
the gradients' all_reduce span the whole mesh; the teacher's forward runs
on the slab too. The step computes the unsharded step up to the order of
float sums. The eval step stays sharded on the batch alone, as JAX's: the
spatial ranks of one data row evaluate the same rows, and the sums run
over the data axis, so none is counted twice.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from tpuseg_torch.core import graphs
from tpuseg_torch.core.mesh import all_reduce_, batch_slice
from tpuseg_torch.data.augment import normalize_images
from tpuseg_torch.models.blocks import frozen_running_stats
from tpuseg_torch.ops.resize import resize_bilinear
from tpuseg_torch.parallel.spatial import spatial_mode
from tpuseg_torch.train.loss import cross_entropy_loss
from tpuseg_torch.train.metrics import confusion_matrix
from tpuseg_torch.train.optim import Optimizer

log = logging.getLogger(__name__)


def forward_nhwc(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """NHWC images -> NHWC logits (views; no copy under channels_last)."""
    return model(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _recompute_contexts():
    """remat: the forward runs as usual; its recomputation in the backward
    leaves the BatchNorm running statistics where the forward put them."""
    return contextlib.nullcontext(), frozen_running_stats()


def _train_forward(model: nn.Module, remat: bool) -> Callable:
    if not remat:
        return lambda x: forward_nhwc(model, x)
    # jax.checkpoint around the forward: activations are recomputed in the
    # backward instead of stored (the forward draws no random numbers)
    return lambda x: checkpoint(forward_nhwc, model, x, use_reentrant=False,
                                preserve_rng_state=False, context_fn=_recompute_contexts)


def _check_finite(loss: torch.Tensor, params) -> None:
    """debug_nans: raise on a loss or gradient that is not finite (before
    the update, so the state keeps its last finite values)."""
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"debug_nans: the loss is {float(loss)}")
    for name, p in params:
        if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
            raise FloatingPointError(f"debug_nans: the gradient of {name} is not finite")


def _active(mesh):
    """The mesh when it has more than one rank, else None."""
    return mesh if mesh is not None and mesh.size > 1 else None


def _uncaptured(mesh, name: str) -> bool:
    """Whether a step over ``mesh`` must run uncaptured (and say so once)."""
    if _active(mesh) is None:
        return False
    if mesh.rank == 0:
        log.info("%s over %d ranks (%s) runs uncaptured: its collectives sync the host",
                 name, mesh.size, mesh.backend)
    return True


def make_step_body(model: nn.Module, optimizer: Optimizer, loss_fn: Optional[Callable] = None,
                   augment_fn: Optional[Callable] = None,
                   generator: Optional[torch.Generator] = None, remat: bool = False,
                   debug_nans: bool = False, mesh=None, grads_bf16: bool = False,
                   teacher_fn: Optional[Callable] = None, spatial: bool = False) -> Callable:
    """One uncaptured step, ``(images, labels) -> loss`` (a detached device
    scalar). With ``augment_fn`` it takes uint8 images and masks and
    augments them first, drawing from ``generator``. Over ``mesh`` it
    takes the global batch and keeps this rank's rows after the augment
    (and its H-slab with ``spatial``); ``loss_fn`` must be built for the
    same mesh (and ``spatial``). With ``teacher_fn`` the loss takes the
    teacher's logits as a third argument."""
    mesh = _active(mesh)
    if mesh is not None and loss_fn is None:
        raise ValueError("a step over a mesh needs a loss_fn built for it (make_loss_fn(mesh=))")
    spatial = spatial and mesh is not None and mesh.spatial > 1
    compute_loss = loss_fn or cross_entropy_loss
    forward = _train_forward(model, remat)
    named = list(model.named_parameters())

    def body(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if augment_fn is not None:
            images, labels = augment_fn(images, labels, generator)
        frame = contextlib.nullcontext()
        if mesh is not None:
            index = batch_slice(mesh, images.shape[:2], 1 if spatial else None)
            if spatial:
                frame = spatial_mode(mesh, images.shape[1], images.shape[2])
            images, labels = images[index], labels[index]
        with frame:
            teacher_logits = None if teacher_fn is None else teacher_fn(images)
            model.train()
            logits = forward(images)
            loss = (compute_loss(logits, labels) if teacher_logits is None
                    else compute_loss(logits, labels, teacher_logits))
            optimizer.zero_grad()
            loss.backward()
        if mesh is not None:
            optimizer.sum_grads(mesh, spatial)
        if debug_nans:
            _check_finite(loss, named)
        grads = None
        if grads_bf16:
            grads = [g.to(torch.bfloat16) for g in optimizer.grads()]
        optimizer.step(grads)
        return loss.detach()

    return body


def make_train_step(model: nn.Module, optimizer: Optimizer, loss_fn: Optional[Callable] = None,
                    augment_fn: Optional[Callable] = None,
                    generator: Optional[torch.Generator] = None, remat: bool = False,
                    debug_nans: bool = False, mesh=None, grads_bf16: bool = False,
                    teacher_fn: Optional[Callable] = None, spatial: bool = False) -> Callable:
    """The step: ``(images f32 [B,H,W,3], labels [B,H,W]) -> {"loss"}``; or,
    with ``augment_fn``, ``(images u8, masks u8) -> {"loss"}`` with the
    augmentation (drawing from ``generator``) fused in front. ``loss_fn``
    defaults to the reference's plain cross-entropy; ``remat`` recomputes
    the forward in the backward. On the card each call replays one CUDA
    graph per input shape. ``debug_nans`` runs op by op (as JAX's debug
    mode does) and raises FloatingPointError on a loss or gradient that is
    not finite. The loss comes back as a device tensor, overwritten by the
    next call: reading it is the caller's choice of when to sync. Over
    ``mesh`` the step is the global one (see the module), uncaptured, with
    the image height sharded too under ``spatial``. ``teacher_fn``
    (``distill.make_teacher_fn``) distills from a teacher."""
    body = make_step_body(model, optimizer, loss_fn, augment_fn, generator, remat, debug_nans,
                          mesh, grads_bf16, teacher_fn, spatial)

    def step(images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"loss": body(images, labels)}

    if debug_nans or _uncaptured(mesh, "the train step"):
        return step
    return graphs.Captured(step, "train_step", _generators(generator))


def make_train_multi_step(k: int, model: nn.Module, optimizer: Optimizer,
                          loss_fn: Optional[Callable] = None,
                          augment_fn: Optional[Callable] = None,
                          generator: Optional[torch.Generator] = None, remat: bool = False,
                          debug_nans: bool = False, mesh=None,
                          grads_bf16: bool = False,
                          teacher_fn: Optional[Callable] = None,
                          spatial: bool = False) -> Callable:
    """K steps per dispatch, the port of ``make_train_multi_step``:
    ``(images [K, B, ...], labels [K, B, ...]) -> {"loss": [K]}``, the same
    arithmetic as K calls of the single step, captured as one graph (over
    ``mesh``, K global steps, uncaptured; H sharded too under
    ``spatial``)."""
    body = make_step_body(model, optimizer, loss_fn, augment_fn, generator, remat, debug_nans,
                          mesh, grads_bf16, teacher_fn, spatial)

    def multi_step(images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        if images.shape[0] != k or labels.shape[0] != k:
            raise ValueError(f"multi step of {k}: got stacks of {images.shape[0]} and "
                             f"{labels.shape[0]}")
        return {"loss": torch.stack([body(images[i], labels[i]) for i in range(k)])}

    if debug_nans or _uncaptured(mesh, f"the {k}-step dispatch"):
        return multi_step
    return graphs.Captured(multi_step, f"train_multi_step_{k}", _generators(generator))


def _generators(generator: Optional[torch.Generator]):
    """The private generator a captured step must register, if any."""
    if generator is None or generator.device.type != "cuda":
        return ()
    return (generator,)


def sum_eval_outputs(eval_step: Callable, batches, device) -> Optional[Dict[str, torch.Tensor]]:
    """The eval step's outputs summed over ``batches`` (``(images, masks,
    n_valid)`` each, as ``InputPipeline.eval_batches`` yields them); None
    when there is no batch."""
    tot = None
    for images, masks, n_valid in batches:
        out = eval_step(images, masks, torch.tensor(n_valid, device=device))
        # a replay's outputs are overwritten by the next: sum into copies
        tot = ({k: v.clone() for k, v in out.items()} if tot is None
               else {k: tot[k] + out[k] for k in out})
    return tot


def make_eval_step(model: nn.Module, num_classes: int, normalize: Optional[Tuple] = None,
                   tta: str = "", ms_scales: Tuple[float, ...] = (0.75, 1.25),
                   ms_divisor: int = 32, mesh=None) -> Callable:
    """``(images, labels, n_valid) -> {"loss_sum", "n", "confusion"}``, all
    device tensors. ``n_valid`` (an int or a device scalar) masks the
    zero-padded tail samples as the JAX step does: their pixels go to class
    C in both prediction and target, and the [C+1, C+1] matrix is cut back
    to [C, C], so every batch has one shape. ``normalize=(mean, std)``: the
    step takes raw uint8 images and normalizes them itself. The per-sample
    loss is the mean over pixels of the CE against a one-hot target, so a
    label outside [0, C) adds 0; the confusion matrix counts no such pixel.

    ``tta``: "" | "flip" | "ms" | "flip+ms", JAX's ladder: flip averages the
    logits with those of the W-mirrored input, mirrored back; ms averages,
    in fp32, the logits at each of ``ms_scales`` (snapped to multiples of
    ``ms_divisor``; a scale that snaps to the input size is skipped),
    bilinearly resized back. On the card each batch shape replays one
    graph.

    Over ``mesh`` the step takes the global batch, evaluates this rank's
    rows (captured as above) and sums the three outputs over the data
    axis, the confusion matrix included, so every rank returns the global
    batch's, as the JAX step's data-sharded jit does."""
    if tta not in ("", "flip", "ms", "flip+ms"):
        raise ValueError(f"unknown tta mode {tta!r} (expected ''|'flip'|'ms'|'flip+ms')")

    def fwd_maybe_flip(x):
        out = forward_nhwc(model, x)
        if "flip" in tta:
            out = 0.5 * (out + torch.flip(forward_nhwc(model, torch.flip(x, [2])), [2]))
        return out

    @torch.inference_mode()
    def eval_step(images: torch.Tensor, labels: torch.Tensor, n_valid):
        if normalize is not None:
            images = normalize_images(images, normalize[0], normalize[1])
        labels = labels.to(torch.int64)
        was_training = model.training
        model.eval()
        logits = fwd_maybe_flip(images)
        if "ms" in tta:
            h, w = images.shape[1], images.shape[2]
            d = int(ms_divisor)
            acc = logits.to(torch.float32)
            n_sc = 1
            for s in ms_scales:
                hs = max(d, int(round(h * s / d)) * d)
                ws = max(d, int(round(w * s / d)) * d)
                if (hs, ws) == (h, w):
                    continue
                ls = fwd_maybe_flip(resize_bilinear(images.to(torch.float32), hs, ws))
                acc = acc + resize_bilinear(ls.to(torch.float32), h, w)
                n_sc += 1
            logits = acc / float(n_sc)
        model.train(was_training)
        b = images.shape[0]
        valid = torch.arange(b, device=logits.device) < n_valid
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        classes = torch.arange(num_classes, device=logits.device)
        onehot = (labels[..., None] == classes).to(logp.dtype)
        per_sample = -(logp * onehot).sum(-1).mean(dim=(1, 2))
        preds = logits.argmax(-1)
        vmask = valid[:, None, None]
        preds_m = torch.where(vmask, preds, num_classes)
        labels_m = torch.where(vmask, labels, num_classes)
        cm = confusion_matrix(preds_m, labels_m, num_classes + 1)[:num_classes, :num_classes]
        return {"loss_sum": (per_sample * valid.to(per_sample.dtype)).sum(),
                "n": valid.to(torch.float32).sum(), "confusion": cm}

    local = graphs.Captured(eval_step, f"eval_step{'_' + tta if tta else ''}")
    mesh = _active(mesh)
    if mesh is None:
        return local

    def global_eval_step(images: torch.Tensor, labels: torch.Tensor, n_valid):
        rows = batch_slice(mesh, images.shape[0])[0]
        n_local = min(max(int(n_valid) - rows.start, 0), rows.stop - rows.start)
        out = local(images[rows], labels[rows],
                    torch.tensor(n_local, device=images.device))
        sums = all_reduce_(torch.stack([out["loss_sum"].to(torch.float64),
                                        out["n"].to(torch.float64)]), mesh, mesh.data_group)
        cm = all_reduce_(out["confusion"].clone(), mesh, mesh.data_group)
        return {"loss_sum": sums[0].to(out["loss_sum"].dtype),
                "n": sums[1].to(out["n"].dtype), "confusion": cm}

    return global_eval_step
