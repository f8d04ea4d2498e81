"""The training driver.

The port of ``tpuseg/train/trainer.py``: config -> data pipeline, model,
the optimizer chain (``train/optim.py``: adam, adamw or sgd, the cosine
schedule, the global-norm clip, MultiSteps, EMA), loss, the fused
augment+train step and the eval step; then the epoch loop with a
one-dispatch-lagged loss read (the host reads dispatch k-1's losses after
it has queued dispatch k), the epoch-end record (eval on the EMA weights
when EMA is on, best tracking, history.jsonl, TensorBoard scalars,
checkpoint), resume, and a checkpoint on SIGTERM.

On the card every dispatch is a replay of a captured CUDA graph
(``core/graphs.py``), the counterpart of the JAX package's jitted step:
``train.steps_per_dispatch=K`` captures K steps into one graph, and steps
per epoch are rounded up to whole groups of K, as in the JAX package.
``debug_nans`` runs the steps op by op and raises FloatingPointError on a
loss or gradient that is not finite; ``profile_dir`` traces ``train()``
with ``torch.profiler``.

The lag does not overlap the host with the card. The read's copy queues
behind replay k on the same stream, and on the card the replay's launch
itself returns only near the end of the graph, so the host waits for the
newest dispatch (the launch for most of it, the read for the rest): the
card drains at the end of every dispatch and idles while the host
collects the next K batches (``PERF.md`` §5, the ``graphs.replay``,
``train.loss_read`` and ``data.wait`` spans).

Spans (``core/trace.py``), recorded while a profiler records (the
``profile_dir`` trace holds them): ``train.epoch`` around each epoch;
inside it ``data.wait`` around each batch the loop waits for (with its
upload enqueued), ``train.dispatch`` around each dispatch (``train.stack``
the K batches' stack inside it), ``train.loss_read`` around each read of
the lagged losses, ``data.stop`` around the producer's shutdown and
``train.epoch_end`` around the epoch-end record (``train.eval`` and
``train.checkpoint`` inside it). The loader's producer thread records
``data.assemble`` per batch.

QAT (``train.qat``) marks the model's conv+BatchNorm convs
(``ops/fake_quant.py``), which then train fake-quantized; distillation
(``train.distill_checkpoint``) builds a frozen teacher
(``_build_distillation``, ``train/distill.py``) whose forward runs inside
the step.

Checkpoints are the port's own format (``tpuseg_torch.core.checkpoint``):
model, optimizer, EMA (its own key), step, epoch and sampler state under
``<checkpoint_dir>/step_<N>.pt``, ``keep_checkpoints`` of them, plus the
best val-mIoU one under ``<checkpoint_dir>/best/`` and ``best.json``.

Data parallelism: in a process group of more than one rank (``python -m
tpuseg_torch.main`` under ``torchrun``, or ``core.mesh.launch_local``)
``--mesh.data`` ranks train one model, as the JAX Trainer does over its
mesh's data axis: every rank draws the same global batch and keeps its
rows, the loss, BatchNorm statistics and gradients are the global
batch's, and the parameters, broadcast from rank 0 after init and after
``init_checkpoint``, stay equal on every rank (``train/train_step.py``).
Rank 0 alone writes checkpoints, ``best.json`` and the epoch records;
every rank resumes from them. Such steps run uncaptured. ``--mesh.spatial``
above one also shards the image height over the mesh's spatial axis, as
the JAX Trainer does (the spatial train step of ``train/train_step.py``;
``data.height`` must divide by it); eval stays sharded on the batch.

The device is the CUDA card unless the caller passes ``device="cpu"``;
with no card and no such request the constructor raises. What the port
does not run yet raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from tpuseg_torch.configs import Config
from tpuseg_torch.core import trace
from tpuseg_torch.core.checkpoint import CheckpointManager
from tpuseg_torch.core.dtypes import resolve_device
from tpuseg_torch.core.mesh import Mesh, all_reduce_, create_mesh, replicate
from tpuseg_torch.data.augment import make_augment_fn
from tpuseg_torch.data.class_stats import resolve_auto_class_weights
from tpuseg_torch.data.combined import CombinedDataset
from tpuseg_torch.data.pipeline import InputPipeline
from tpuseg_torch.data.sources import build_source
from tpuseg_torch.models.blocks import set_mesh
from tpuseg_torch.ops.fake_quant import set_qat
from tpuseg_torch.models.registry import build_model, validate_input_size
from tpuseg_torch.train.loss import make_loss_fn
from tpuseg_torch.train.metrics import (iou_from_confusion, mean_iou,
                                        pixel_accuracy_from_confusion)
from tpuseg_torch.train.optim import build_optimizer
from tpuseg_torch.train.train_step import (make_eval_step, make_train_multi_step,
                                           make_train_step, sum_eval_outputs)

log = logging.getLogger(__name__)


def _loss_list(loss: torch.Tensor) -> List[float]:
    """A scalar (one step) or [K] (K steps) device loss -> python floats."""
    return np.atleast_1d(loss.cpu().numpy()).tolist()


def trainer_mesh(cfg: Config):
    """The Trainer's mesh: None for one process (``--mesh.data`` -1 or 1,
    ``--mesh.spatial`` 1 and no process group, or a mesh of one rank),
    else ``create_mesh`` over the process group's first ``data x spatial``
    ranks, which raises when there are fewer."""
    if not dist.is_initialized() and cfg.mesh.data in (-1, 1) and cfg.mesh.spatial <= 1:
        return None
    return _active_mesh(create_mesh(cfg.mesh.data, cfg.mesh.spatial))


def _active_mesh(mesh: Mesh) -> Optional[Mesh]:
    """``mesh`` when it has more than one rank, else None; a rank that the
    mesh leaves idle has nothing to train (``tpuseg_torch.main`` returns
    there before building a Trainer)."""
    if mesh.idle:
        raise ValueError(f"rank {mesh.rank} is outside the {mesh.data}x{mesh.spatial} mesh: "
                         "it has no work")
    return mesh if mesh.size > 1 else None


class Trainer:
    """Wires config -> pipeline, model, optimizer, steps; runs train/eval."""

    def __init__(self, cfg: Config, combined: Optional[CombinedDataset] = None,
                 device: Optional[Union[str, torch.device]] = None, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # ``mesh``: one already created for this rank (``tpuseg_torch.main``)
        self.mesh = trainer_mesh(cfg) if mesh is None else _active_mesh(mesh)
        self._writes = self.mesh is None or self.mesh.rank == 0
        if self.mesh is not None and self.mesh.rank == 0:
            log.info("mesh: %s", self.mesh)
        if combined is None:
            sources = [build_source(s, cfg.data.width, cfg.data.height)
                       for s in cfg.data.sources]
            weights = [s.weight for s in cfg.data.sources]
            combined = CombinedDataset(sources, weights=weights if any(weights) else None,
                                       val_split=cfg.data.val_split, seed=cfg.data.seed)
        if self.mesh is not None and cfg.train.batch_size % self.mesh.shape["data"] != 0:
            raise ValueError(
                f"batch_size {cfg.train.batch_size} must be divisible by the "
                f"mesh data axis ({self.mesh.shape['data']} devices)")
        # mesh.spatial > 1 shards the H dim across the "spatial" axis —
        # checked BEFORE model init so an indivisible height fails fast
        self.spatial = self.mesh is not None and self.mesh.shape["spatial"] > 1
        if self.spatial and cfg.data.height % self.mesh.shape["spatial"] != 0:
            raise ValueError(
                f"data.height {cfg.data.height} must be divisible by the "
                f"mesh spatial axis ({self.mesh.shape['spatial']})")
        validate_input_size(cfg.model.name, cfg.data.height, cfg.data.width)
        self.combined = combined
        log.info("%s", combined.summary())
        self.pipeline = InputPipeline(
            combined, batch_size=cfg.train.batch_size, height=cfg.data.height,
            width=cfg.data.width, device=self.device, seed=cfg.data.seed,
            prefetch=cfg.data.prefetch, cache_bytes=cfg.data.cache_bytes)

        self.model = build_model(cfg.model, seed=cfg.train.seed).to(
            self.device, memory_format=torch.channels_last)
        replicate(set_mesh(self.model, self.mesh), self.mesh)
        t = cfg.train
        # the EMA is seeded from the parameters here, before init_checkpoint
        # loads, as create_train_state seeds it in the JAX package
        self.optimizer = build_optimizer(self.model, t, t.epochs * self.steps_per_epoch())
        if t.ema_decay > 0:
            self._warn_ema_horizon()
        if t.init_checkpoint:
            self._load_init_checkpoint(t.init_checkpoint)
        self.augment = make_augment_fn(
            cfg.data.height, cfg.data.width, heavy=cfg.data.heavy_augment,
            augment=cfg.data.augment, mean=cfg.data.normalize_mean,
            std=cfg.data.normalize_std)
        self.aug_generator = torch.Generator(device=self.device).manual_seed(
            cfg.data.seed + 1)
        self.steps_per_dispatch = max(1, t.steps_per_dispatch)
        if t.qat:
            # every conv+BatchNorm conv trains fake-quantized (int8 grids,
            # straight-through gradients); the state_dict is unchanged
            log.info("qat: %d convs fake-quantized", set_qat(self.model))
        # the step's loss and teacher forward (None: plain CE, no teacher)
        self.loss_fn, self.teacher, self.teacher_fn = self._build_loss(), None, None
        if t.distill_checkpoint:
            if t.distill_alpha <= 0.0:
                # alpha=0 means KD off: no teacher is built or run
                log.warning("distill_alpha=0 — ignoring distill_checkpoint %r",
                            t.distill_checkpoint)
            else:
                self.loss_fn, self.teacher_fn = self._build_distillation(self.loss_fn)
        step_kw = dict(loss_fn=self.loss_fn, augment_fn=self.augment,
                       generator=self.aug_generator, remat=t.remat, debug_nans=t.debug_nans,
                       mesh=self.mesh, grads_bf16=t.grads_bf16, teacher_fn=self.teacher_fn,
                       spatial=self.spatial)
        if self.steps_per_dispatch > 1:
            self.train_step = make_train_multi_step(self.steps_per_dispatch, self.model,
                                                    self.optimizer, **step_kw)
        else:
            self.train_step = make_train_step(self.model, self.optimizer, **step_kw)
        self.eval_step = make_eval_step(
            self.model, cfg.model.num_classes,
            normalize=(cfg.data.normalize_mean, cfg.data.normalize_std),
            tta=t.eval_tta, ms_scales=t.eval_tta_scales, mesh=self.mesh)
        self.profiler = None        # the torch.profiler of the last profiled train()
        self._tb = None
        if t.tensorboard_dir and self._writes:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise NotImplementedError(
                    "tensorboard_dir needs torch.utils.tensorboard (the tensorboard "
                    "package), which does not import here (ROADMAP.md A7, train)") from e
            self._tb = SummaryWriter(t.tensorboard_dir)

        self.ckpt: Optional[CheckpointManager] = None
        self.best_ckpt: Optional[CheckpointManager] = None
        if cfg.train.checkpoint_dir:
            self.ckpt = CheckpointManager(cfg.train.checkpoint_dir,
                                          max_to_keep=cfg.train.keep_checkpoints,
                                          mesh=self.mesh)
            # the best-val-mIoU checkpoint has its own always-kept slot
            self.best_ckpt = CheckpointManager(
                os.path.join(cfg.train.checkpoint_dir, "best"), max_to_keep=1, mesh=self.mesh)
        self.step = 0
        self.epoch = 0              # epochs completed (checkpointed)
        self.history: List[Dict] = []
        self.step_losses: List[float] = []   # every step's loss, this process
        self._history_path = cfg.train.history_file
        if not self._history_path and cfg.train.checkpoint_dir:
            self._history_path = os.path.join(cfg.train.checkpoint_dir, "history.jsonl")
        if self._history_path == "none":
            self._history_path = ""
        self._best_miou = float("-inf")
        self._es_best = float("-inf")
        self._es_stale = 0
        self._stop_early = False
        self._preempted = False

    def _warn_ema_horizon(self) -> None:
        """A decay whose ~1/(1-d)-step time constant exceeds the run leaves
        the served EMA weights dominated by the random init (eval, best and
        serving use them): warn, as the JAX Trainer does."""
        t = self.cfg.train
        total = t.epochs * self.steps_per_epoch()
        horizon = 1.0 / max(1e-9, 1.0 - t.ema_decay)
        if total < 3 * horizon:
            log.warning(
                "ema_decay=%g has a ~%d-step time constant but this run is only %d "
                "steps: the served EMA tree will lag far behind the raw weights. Pick "
                "decay so 1/(1-decay) is well under the step count (e.g. %.3g).",
                t.ema_decay, int(horizon), total, max(0.0, 1.0 - 10.0 / max(total, 10)))

    def _tb_scalars(self, rec: Dict) -> None:
        """The epoch record's numbers as TensorBoard scalars at its step."""
        if self._tb is None:
            return
        for key, value in rec.items():
            if isinstance(value, (int, float)) and key != "step":
                self._tb.add_scalar(key, value, global_step=rec["step"])
        self._tb.flush()

    def _build_loss(self):
        """None => the step's default (plain CE); else make_loss_fn's loss
        (always over a mesh: its CE must sum over the ranks).
        ``class_weights=auto[:median|:inverse]`` is resolved against this
        run's own train split (``self.class_weights`` keeps the result)."""
        t = self.cfg.train
        self.class_weights = None
        if (t.loss in ("", "ce") and not t.class_weights and t.label_smoothing == 0.0
                and t.ignore_index < 0 and self.mesh is None):
            return None
        if isinstance(t.class_weights, str):
            weights = resolve_auto_class_weights(self.combined, self.cfg.model.num_classes,
                                                 spec=t.class_weights)
            log.info("resolved --train.class_weights=%s -> %s "
                     "(freeze with an explicit list for exact reproducibility)",
                     t.class_weights, ",".join(f"{w:.4f}" for w in weights))
        else:
            weights = tuple(float(w) for w in t.class_weights) or None
        self.class_weights = weights
        if weights is not None and len(weights) != self.cfg.model.num_classes:
            raise ValueError(
                f"train.class_weights has {len(weights)} entries; model has "
                f"{self.cfg.model.num_classes} classes")
        return make_loss_fn(
            t.loss, class_weights=weights, label_smoothing=t.label_smoothing,
            focal_gamma=t.focal_gamma, dice_weight=t.dice_weight,
            ignore_index=t.ignore_index if t.ignore_index >= 0 else None,
            lovasz_bins=t.lovasz_bins, mesh=self.mesh, spatial=self.spatial)

    def _build_distillation(self, loss_fn):
        """The frozen teacher and the combined loss (``train.distill_*``),
        as the JAX Trainer builds them: the teacher is the model config with
        ``distill_model``/``distill_base_filters``/``distill_width_mult``
        in place and ``use_pallas`` off, loaded from ``distill_checkpoint``
        (any checkpoint ``load_variables`` reads; its EMA weights when it
        has them), checked at build time. Returns (loss, teacher_fn)."""
        import dataclasses

        from tpuseg_torch.infer.predictor import load_checkpoint
        from tpuseg_torch.train.distill import make_distill_loss, make_teacher_fn
        from tpuseg_torch.train.loss import cross_entropy_loss

        t, m = self.cfg.train, self.cfg.model
        t_cfg = dataclasses.replace(
            m, name=t.distill_model or m.name,
            base_filters=t.distill_base_filters or m.base_filters,
            width_mult=t.distill_width_mult or m.width_mult,
            # the fused decoder kernel is eval-only and single-card
            use_pallas=False)
        teacher = build_model(t_cfg)
        weights, quant = load_checkpoint(t.distill_checkpoint, teacher.state_dict)
        if quant:
            raise ValueError(
                f"distill_checkpoint {t.distill_checkpoint!r} carries a calibrated int8 "
                "'quant' collection — distill from the fp32 training checkpoint "
                "instead")
        # fail at build time, not at the first step
        try:
            teacher.load_state_dict(weights, strict=True)
            with torch.no_grad():
                probe = teacher.eval()(torch.zeros(1, 3, self.cfg.data.height,
                                                   self.cfg.data.width))
        except (RuntimeError, KeyError, ValueError) as e:
            raise ValueError(
                f"distill_checkpoint {t.distill_checkpoint!r} does not match teacher model "
                f"{t_cfg.name!r} (base_filters={t.distill_base_filters}, width_mult="
                f"{t.distill_width_mult}): {e}") from e
        if probe.shape[1] != m.num_classes:
            raise ValueError(f"teacher predicts {probe.shape[1]} classes; student has "
                             f"{m.num_classes}")
        self.teacher = teacher.to(self.device, memory_format=torch.channels_last)
        log.info("distillation: teacher=%s from %s, alpha=%.2f, T=%.1f", t_cfg.name,
                 t.distill_checkpoint, t.distill_alpha, t.distill_temperature)
        return (make_distill_loss(loss_fn or cross_entropy_loss, t.distill_alpha,
                                  t.distill_temperature, ignore_index=t.ignore_index,
                                  mesh=self.mesh, spatial=self.spatial),
                make_teacher_fn(self.teacher))

    def _load_init_checkpoint(self, path: str) -> None:
        """Weights (and BN statistics) from any checkpoint ``load_variables``
        reads (a reference ``.pth``, a checkpoint directory of the port, as
        ``tpuseg_torch.tools.import_pretrained`` and ``tools/orbax_to_torch.py``
        write them); optimizer and sampler untouched."""
        from tpuseg_torch.infer.predictor import load_variables

        self.model.load_state_dict(load_variables(path, self.model.state_dict))
        replicate(self.model, self.mesh)
        log.info("initialized params from %s", path)

    # -- checkpointing -------------------------------------------------------

    def _checkpoint_payload(self) -> dict:
        payload = {"model": self.model.state_dict(),
                   "optimizer": self.optimizer.state_dict(),
                   "step": self.step, "epoch": self.epoch,
                   "sampler": self.pipeline.state()["sampler"]}
        if self.optimizer.ema_decay > 0:
            # its own key, as the JAX package's ema_params: EMA-off
            # checkpoints keep their shape
            payload["ema"] = self.optimizer.ema_state_dict(self.model)
        return payload

    def save_checkpoint(self) -> None:
        if self.ckpt is not None:
            self.ckpt.save(self.step, self._checkpoint_payload())

    def maybe_resume(self) -> bool:
        """Restore the latest checkpoint of ``checkpoint_dir``; False when
        there is none. Everything is copied into the existing tensors, so
        a step captured before the resume runs on the restored state."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        saved = self.ckpt.restore(map_location=self.device)
        self.model.load_state_dict(saved["model"])
        self.optimizer.load_state_dict(saved["optimizer"])
        if self.optimizer.ema_decay > 0:
            if "ema" in saved:
                self.optimizer.load_ema(self.model, saved["ema"])
            else:
                log.info("checkpoint has no EMA tree; seeding EMA from restored params")
                self.optimizer.load_ema(self.model, dict(self.model.named_parameters()))
        elif "ema" in saved:
            log.warning("checkpoint carries an EMA tree but --train.ema_decay=0; "
                        "restoring raw params and discarding the EMA average")
        self.step, self.epoch = int(saved["step"]), int(saved["epoch"])
        self.pipeline.restore({"sampler": saved["sampler"]})
        best_json = os.path.join(self.cfg.train.checkpoint_dir, "best.json")
        if os.path.exists(best_json):
            try:
                with open(best_json) as f:
                    self._best_miou = float(json.load(f)["val_miou"])
            except (ValueError, KeyError, OSError):
                log.warning("unreadable best.json; best watermark reset")
        log.info("resumed from step %d", self.step)
        return True

    # -- loops ---------------------------------------------------------------

    def steps_per_epoch(self) -> int:
        if self.cfg.train.steps_per_epoch > 0:
            return self.cfg.train.steps_per_epoch
        return max(1, self.combined.train_size // self.cfg.train.batch_size)

    def _install_preemption_handler(self):
        """SIGTERM -> finish the running step, checkpoint, stop. Returns the
        callback that restores the previous handler (a no-op off the main
        thread, where signals cannot be bound)."""
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return lambda: None
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self._preempted = True
            log.warning("SIGTERM: will checkpoint and stop after the current step")

        signal.signal(signal.SIGTERM, handler)
        return lambda: signal.signal(signal.SIGTERM, prev)

    def train(self, epochs: Optional[int] = None) -> List[Dict]:
        cfg = self.cfg.train
        epochs = epochs if epochs is not None else cfg.epochs
        self._preempted = False
        restore_signal = self._install_preemption_handler()
        k = self.steps_per_dispatch
        # round steps/epoch up to a whole number of dispatch groups
        spe = -(-self.steps_per_epoch() // k) * k
        if cfg.resume:
            self.maybe_resume()
        start_epoch = self.epoch
        profiler = self._start_profiler()
        try:
            for epoch in range(start_epoch, epochs):
                with trace.span("train.epoch"):
                    t0 = time.perf_counter()
                    # a mid-epoch (preemption) checkpoint resumes into its epoch,
                    # at a whole dispatch group
                    done = 0
                    if epoch == start_epoch:
                        done = min(max(0, self.step - epoch * spe), spe)
                        done -= done % k
                    steps_this = spe - done
                    if steps_this <= 0:
                        # resumed exactly at an epoch boundary whose epoch-end never ran
                        self.epoch = epoch + 1
                        self._epoch_end(epoch, [], 0.0, 0)
                        if self._stop_early:
                            break
                        continue
                    losses = self._run_epoch_steps(steps_this, epoch, epochs)
                    if self._preempted:
                        if self.ckpt is None:
                            log.warning("preempted at step %d — no checkpoint_dir set, "
                                        "progress is lost", self.step)
                        else:
                            with trace.span("train.checkpoint"):
                                self.save_checkpoint()
                            log.warning("preempted at step %d — checkpoint saved", self.step)
                        break
                    self.epoch = epoch + 1
                    self._epoch_end(epoch, losses, time.perf_counter() - t0, steps_this)
                    if self._stop_early:
                        break
        finally:
            restore_signal()
            self._stop_profiler(profiler)
        return self.history

    def _start_profiler(self):
        """profile_dir: torch.profiler over ``train()`` (CPU, and CUDA on the card)."""
        if not self.cfg.train.profile_dir:
            return None
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        return prof

    def _stop_profiler(self, prof) -> None:
        """Stop the trace and write it as ``<profile_dir>/train_<pid>_step<N>.trace.json``."""
        if prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        os.makedirs(self.cfg.train.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.cfg.train.profile_dir, f"train_{os.getpid()}_step{self.step}.trace.json"))
        self.profiler = prof

    def _preempted_everywhere(self) -> bool:
        """Whether a SIGTERM reached this rank, or any rank of the mesh: the
        ranks stop after the same step, or one would wait for the others
        in its next collective."""
        if self.mesh is None:
            return self._preempted
        flag = torch.tensor([float(self._preempted)], device=self.device)
        all_reduce_(flag, self.mesh, self.mesh.group, dist.ReduceOp.MAX)
        self._preempted = bool(flag.item())
        return self._preempted

    def _run_epoch_steps(self, steps: int, epoch: int, epochs: int) -> List[float]:
        cfg = self.cfg.train
        k = self.steps_per_dispatch
        losses: List[float] = []
        pending = None      # the previous dispatch's losses, read one dispatch late
        batch_gen = self.pipeline.train_batches(steps)
        batches = batch_gen
        if cfg.progress:
            try:
                from tqdm import tqdm

                batches = tqdm(batch_gen, total=steps, desc=f"epoch {epoch + 1}/{epochs}")
            except ImportError:  # pragma: no cover
                pass
        group: List = []
        it = iter(batches)
        try:
            for _ in range(steps):
                with trace.span("data.wait"):
                    item = next(it, None)
                if item is None:
                    break
                group.append(item)
                if len(group) < k:
                    continue
                with trace.span("train.dispatch"):
                    if k == 1:
                        metrics = self.train_step(*item)
                    else:
                        with trace.span("train.stack"):
                            stacked = [torch.stack(t) for t in zip(*group)]
                        # freed now, not at the next dispatch: the next
                        # batches' uploads reuse their memory
                        metrics = self.train_step(*stacked)
                        del stacked
                    # a replay's loss is the graph's output tensor, which the
                    # next replay overwrites: keep a copy (queued before that
                    # replay)
                    loss = metrics["loss"].clone()
                group = []
                self.step += k
                if pending is not None:
                    with trace.span("train.loss_read"):
                        losses.extend(_loss_list(pending))
                pending = loss
                if cfg.log_every and self.step % cfg.log_every < k and losses and self._writes:
                    log.info("step %d | loss %.4f", self.step, losses[-1])
                if self._preempted_everywhere():
                    break
        finally:
            # stop the producer before anything reads the sampler's state
            with trace.span("data.stop"):
                batch_gen.close()
                if batches is not batch_gen:
                    batches.close()
        if pending is not None:
            with trace.span("train.loss_read"):
                losses.extend(_loss_list(pending))
        self.step_losses.extend(losses)
        return losses

    def _epoch_end(self, epoch: int, losses: list, dt: float, steps_this: int) -> None:
        """Epoch record + eval + best tracking + early stop + checkpoint."""
        with trace.span("train.epoch_end"):
            cfg = self.cfg.train
            rec = {
                "epoch": epoch + 1,
                "step": self.step,
                "train_loss": float(np.mean(losses)) if losses else float("nan"),
                "imgs_per_sec": steps_this * cfg.batch_size / max(dt, 1e-9),
                "seconds": dt,
            }
            if (self.combined.val_size > 0 and cfg.eval_every_epochs
                    and (epoch + 1) % cfg.eval_every_epochs == 0):
                with trace.span("train.eval"):
                    rec.update(self.evaluate())
                miou = rec.get("val_miou")
                if miou is not None and cfg.early_stop_patience > 0:
                    if miou > self._es_best + cfg.early_stop_min_delta:
                        self._es_best, self._es_stale = miou, 0
                    else:
                        self._es_stale += 1
                        if self._es_stale >= cfg.early_stop_patience:
                            self._stop_early = True
                            rec["early_stop"] = True
                if miou is not None and miou > self._best_miou:
                    self._best_miou = miou
                    rec["best"] = True
                    if cfg.checkpoint_dir and self._writes:
                        with open(os.path.join(cfg.checkpoint_dir, "best.json"), "w") as f:
                            json.dump({"step": self.step, "val_miou": miou}, f)
                    if self.best_ckpt is not None:
                        with trace.span("train.checkpoint"):
                            self.best_ckpt.save(self.step, self._checkpoint_payload())
            self.history.append(rec)
            if self._writes:
                log.info("%s", json.dumps(rec))
            if self._history_path and self._writes:
                with open(self._history_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            self._tb_scalars(rec)
            if cfg.save_every_epochs and (epoch + 1) % cfg.save_every_epochs == 0:
                with trace.span("train.checkpoint"):
                    self.save_checkpoint()

    @contextlib.contextmanager
    def _eval_weights(self) -> Iterator[None]:
        """With EMA on, the EMA parameters stand in the model's parameter
        tensors (copied in place, so the captured eval step reads them)
        until the block ends; the BatchNorm statistics stay shared, as in
        the JAX package."""
        if self.optimizer.ema_decay <= 0:
            yield
            return
        params = list(self.model.parameters())
        with torch.no_grad():
            raw = [p.detach().clone() for p in params]
            for p, e in zip(params, self.optimizer.state["ema"]):
                p.copy_(e)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, r in zip(params, raw):
                    p.copy_(r)

    def evaluate(self) -> Dict[str, float]:
        """Full pass over the val split: loss, pixel acc, per-class IoU, mIoU,
        on the EMA weights when EMA is on (eval and best tracking select
        the weights that are served)."""
        with self._eval_weights():
            tot = sum_eval_outputs(self.eval_step, self.pipeline.eval_batches(), self.device)
        if tot is None or float(tot["n"]) == 0:
            return {}
        cm = tot["confusion"].cpu().numpy()
        iou = iou_from_confusion(cm)
        return {
            "val_loss": float(tot["loss_sum"]) / float(tot["n"]),
            "val_pixel_acc": pixel_accuracy_from_confusion(cm),
            "val_miou": mean_iou(cm),
            "val_iou_per_class": [None if np.isnan(v) else float(v) for v in iou],
        }
