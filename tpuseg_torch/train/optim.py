"""The optimizer chain of the JAX Trainer, written against optax's formulas.

The port of ``Trainer._build_optimizer`` (``tpuseg/train/trainer.py``):

    [MultiSteps(k)] o [clip_by_global_norm(c)] o {adam | adamw | sgd} o lr

- ``adam``: optax's ``scale_by_adam`` (mu, nu, bias correction at count+1,
  ``mu_hat / (sqrt(nu_hat) + eps)``);
- ``adamw``: the same, then ``+ weight_decay * param`` for every parameter
  (``optax.adamw`` with no mask);
- ``sgd``: optax's ``trace``: ``t = g + momentum * t`` from zeros, so the
  first update is the gradient;
- the learning rate is a constant or optax's
  ``warmup_cosine_decay_schedule(0, lr, warmup_steps, total_steps)``,
  evaluated at the inner count, so with warmup the first update uses 0;
- ``clip_norm > 0``: the global L2 norm clip of the (k-averaged) gradient;
- ``accum > 1``: ``optax.MultiSteps``: the gradients' running mean over k
  micro-steps; the inner update, and the counts that drive the bias
  correction and the schedule, move on the k-th only;
- ``mu_dtype`` (``--train.mu_dtype``, None or bf16): the dtype in which
  Adam's first moment, or SGD's momentum trace (optax's
  ``accumulator_dtype``), is stored. As optax's ``scale_by_adam``, the
  update is taken from the new moment before it is cast for storing
  (``mu_hat`` from the uncast moment); ``b1 * mu`` reads the stored one,
  so it is rounded to its dtype, as JAX rounds a python float times a bf16
  array. ``nu`` stays in the parameters' dtype.

The gradients handed to ``step`` may be bf16 (``grads_bf16``, cast by the
train step), and then every formula above rounds where optax's does with
bf16 leaves: torch and JAX promote a python float times a bf16 tensor to
bf16, and bf16 with fp32 to fp32. The global norm of the clip is taken
as optax's is, over the bf16 leaves: each leaf's squared sum in bf16, the
leaves summed one by one, as optax's python ``sum`` adds them.

Every count and the learning rate are device tensors that the step itself
advances, and no step reads a device value on the host, so a CUDA graph
of K steps applies K learning rates. The inner update is computed at
every micro-step and selected with ``torch.where``, as the graph cannot
branch on a device value. An exponential moving average of the
parameters (``ema_decay``) moves after each applied update, and under
``accum`` only on the micro-step that applied one.

The state is made at construction, and ``load_state_dict`` copies into it
in place, so a captured step still points at it after a resume.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from tpuseg_torch.core.mesh import all_reduce_

OPTIMIZERS = ("adam", "adamw", "sgd")
MU_DTYPES = {"": None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def _weak(v: float, t: torch.Tensor) -> float:
    """The python float ``v`` as JAX applies it to ``t``: a weakly typed
    scalar takes ``t``'s dtype, so against a bf16 tensor it is rounded to
    bf16 first (torch would multiply by the unrounded value in fp32)."""
    return v if t.dtype != torch.bfloat16 else _bf16(v)


@functools.lru_cache(maxsize=None)
def _bf16(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float64).to(torch.bfloat16))


class Optimizer:
    """One optax-equivalent chain over a model's parameters."""

    def __init__(self, params, optimizer: str = "adam", lr: float = 1.5e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, momentum: float = 0.9,
                 lr_schedule: str = "", warmup_steps: int = 0, total_steps: int = 0,
                 clip_norm: float = 0.0, accum: int = 1, ema_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None):
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {optimizer!r}")
        if lr_schedule not in ("", "cosine"):
            raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
        if lr_schedule and total_steps - warmup_steps <= 0:
            raise ValueError(f"cosine decay needs total_steps ({total_steps}) > "
                             f"warmup_steps ({warmup_steps})")
        self.params: List[nn.Parameter] = list(params)
        self.kind, self.lr, self.b1, self.b2, self.eps = optimizer, lr, b1, b2, eps
        self.weight_decay, self.momentum = weight_decay, momentum
        self.lr_schedule, self.warmup_steps, self.total_steps = (
            lr_schedule, warmup_steps, total_steps)
        self.clip_norm, self.accum, self.ema_decay = clip_norm, max(1, accum), ema_decay
        p0 = self.params[0]
        zeros = lambda dtype=None: [torch.zeros_like(p, dtype=dtype,
                                                     memory_format=torch.preserve_format)
                                    for p in self.params]
        self.state: Dict[str, object] = {
            # inner updates applied (optax's adam/schedule count)
            "count": torch.zeros((), dtype=torch.int64, device=p0.device)}
        if optimizer == "sgd":
            self.state["trace"] = zeros(mu_dtype)
        else:
            self.state["mu"], self.state["nu"] = zeros(mu_dtype), zeros()
        if self.accum > 1:
            self.state["mini_step"] = torch.zeros((), dtype=torch.int64, device=p0.device)
            self.state["acc"] = zeros()
        if ema_decay > 0:
            with torch.no_grad():
                self.state["ema"] = [p.detach().clone() for p in self.params]

    # -- the schedule ----------------------------------------------------------

    def learning_rate(self, count: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The learning rate at inner count ``count``, a device scalar. The
        schedule computes in float32, as optax's does whatever the
        parameters' type."""
        if not self.lr_schedule:
            return torch.full((), self.lr, dtype=dtype, device=count.device)
        c = count.to(torch.float32)
        w = self.warmup_steps
        if w > 0:
            frac = 1.0 - torch.clamp(c, 0, w) / w
            warm = (0.0 - self.lr) * frac + self.lr
        else:
            warm = torch.zeros_like(c)
        decay_steps = self.total_steps - w
        t = torch.clamp(c - w, max=decay_steps)
        cos = self.lr * (0.5 * (1.0 + torch.cos(math.pi * t / decay_steps)))
        return torch.where(c < w, warm, cos).to(dtype)

    # -- the update ------------------------------------------------------------

    def zero_grad(self) -> None:
        """Drop the gradients: the next backward writes them anew (inside a
        capture, into the graph's own memory)."""
        for p in self.params:
            p.grad = None

    def grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def sum_grads(self, mesh) -> None:
        """Sum every parameter's gradient over the mesh's data axis: ONE
        all_reduce of them flattened, before the clip and the update, so
        the clip sees the global norm and every rank applies one update.
        Each rank's gradient is its part (see ``train/loss.py``)."""
        grads = self.grads()
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh, mesh.data_group)
        for p, part in zip(self.params, flat.split([g.numel() for g in grads])):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.copy_(part.view(p.shape))

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        """One update from ``grads`` (default: the parameters' own
        gradients; the train step hands bf16 casts of them under
        ``grads_bf16``). New moments are stored in place, cast to their
        state's dtype."""
        st = self.state
        grads = self.grads() if grads is None else grads
        emit = None
        if self.accum > 1:
            n = st["mini_step"]
            # Welford mean, as optax.MultiSteps: acc + (g - acc) / (n + 1)
            acc = [a + (g - a) / (n + 1).to(g.dtype) for a, g in zip(st["acc"], grads)]
            emit = n == self.accum - 1
            grads = acc
        if self.clip_norm > 0:
            # optax's global_norm: sqrt of the sum of the leaves' squared
            # sums, added leaf by leaf in the leaves' dtype
            norm = sum(torch.sum(g * g) for g in grads)
            norm = torch.sqrt(norm)
            keep = norm < _weak(self.clip_norm, norm)
            grads = [torch.where(keep, g, (g / norm.to(g.dtype)) * _weak(self.clip_norm, g))
                     for g in grads]
        count = st["count"]
        dtype = self.params[0].dtype
        if self.kind == "sgd":
            new_trace = [g + _weak(self.momentum, t) * t for g, t in zip(grads, st["trace"])]
            updates = new_trace
            new_state = {"trace": new_trace}
        else:
            c1 = (count + 1).to(dtype)
            new_mu = [_weak(1 - self.b1, g) * g + _weak(self.b1, m) * m
                      for g, m in zip(grads, st["mu"])]
            new_nu = [_weak(1 - self.b2, g) * (g * g) + _weak(self.b2, v) * v
                      for g, v in zip(grads, st["nu"])]
            bc1, bc2 = 1 - torch.pow(self.b1, c1), 1 - torch.pow(self.b2, c1)
            # the update from the new moments as they are, before mu is
            # cast for storing (optax's order)
            updates = [(m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + self.eps)
                       for m, v in zip(new_mu, new_nu)]
            if self.kind == "adamw":
                updates = [u + self.weight_decay * p for u, p in zip(updates, self.params)]
            new_state = {"mu": new_mu, "nu": new_nu}
        step_size = -self.learning_rate(count, dtype)
        updates = [step_size.to(u.dtype) * u for u in updates]

        if emit is None:
            for name, vals in new_state.items():
                for dst, v in zip(st[name], vals):
                    dst.copy_(v)
            count.add_(1)
            for p, u in zip(self.params, updates):
                p.add_(u)
            self._ema_update(None)
            return
        # MultiSteps: the inner state moves, and the update applies, on emit
        for name, vals in new_state.items():
            for dst, v in zip(st[name], vals):
                dst.copy_(torch.where(emit, v, dst))
        count.add_(emit.to(count.dtype))
        emit_f = emit.to(dtype)
        for p, u in zip(self.params, updates):
            p.add_(emit_f * u)
        for dst, a in zip(st["acc"], acc):
            dst.copy_((1 - emit_f) * a)
        st["mini_step"].copy_(torch.remainder(st["mini_step"] + 1, self.accum))
        self._ema_update(emit)

    def _ema_update(self, emit: Optional[torch.Tensor]) -> None:
        if self.ema_decay <= 0:
            return
        d = self.ema_decay
        for e, p in zip(self.state["ema"], self.params):
            new = e * d + p * (1.0 - d)
            e.copy_(new if emit is None else torch.where(emit, new, e))

    # -- EMA weights and checkpoints ---------------------------------------------

    def ema_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The EMA parameters under the model's parameter names."""
        by_id = {id(p): e for p, e in zip(self.params, self.state["ema"])}
        return {k: by_id[id(p)] for k, p in model.named_parameters()}

    @torch.no_grad()
    def load_ema(self, model: nn.Module, named: Dict[str, torch.Tensor]) -> None:
        """Copy EMA parameters given by name into the EMA state in place."""
        for (k, _), e in zip(model.named_parameters(), self.state["ema"]):
            e.copy_(named[k])

    def state_dict(self) -> dict:
        """The optimizer's state without the EMA (which the Trainer saves
        under its own key)."""
        return {k: list(v) if isinstance(v, list) else v
                for k, v in self.state.items() if k != "ema"}

    @torch.no_grad()
    def load_state_dict(self, saved: dict) -> None:
        """Copy ``saved`` into the state in place (a captured step keeps
        pointing at the same tensors)."""
        missing = set(self.state) - set(saved) - {"ema"}
        if missing:
            raise KeyError(f"optimizer state lacks {sorted(missing)}: saved with other "
                           "optimizer options")
        for k, dst in self.state.items():
            if k == "ema":
                continue
            src = saved[k]
            if isinstance(dst, list):
                if len(src) != len(dst):
                    raise ValueError(f"optimizer state {k!r}: {len(src)} tensors, "
                                     f"want {len(dst)}")
                for d, s in zip(dst, src):
                    d.copy_(s)
            else:
                dst.copy_(src)


def build_optimizer(model: nn.Module, cfg_train, total_steps: int = 0) -> Optimizer:
    """The Trainer's chain from ``train`` config fields; ``total_steps`` is
    the cosine horizon (epochs * steps per epoch)."""
    t = cfg_train
    if t.mu_dtype not in MU_DTYPES:
        raise ValueError(f"train.mu_dtype={t.mu_dtype!r}: expected ''|'bfloat16'|'float32'")
    return Optimizer(model.parameters(), optimizer=t.optimizer, lr=t.lr, b1=t.b1, b2=t.b2,
                     eps=t.eps, weight_decay=t.weight_decay, momentum=t.momentum,
                     lr_schedule=t.lr_schedule, warmup_steps=t.warmup_steps,
                     total_steps=max(1, total_steps), clip_norm=t.grad_clip_norm,
                     accum=t.grad_accum, ema_decay=t.ema_decay,
                     mu_dtype=MU_DTYPES[t.mu_dtype])
