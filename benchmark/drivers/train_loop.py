"""Training traffic: ``Trainer.train`` epoch after epoch for the window.

Set-up: the cell's scenes are made on the device from the seed and written
in the program's packed format under ``TMPDIR`` (removed at exit); the
program's ``Trainer`` is built from the configuration's and the cell's
flags over that packed set, TF32 off as the program's entry point sets it;
the seeded weights are copied into its model. One dispatch warms up and
captures the step; the seeded state is then put back in place and the
same Trainer is handed to the window.

The window runs the Trainer's own epochs (one pass of the set each) until
``--seconds`` have passed; the rate counts every image of every step of
those epochs over the whole window. Its first dispatch starts from the
seeded state: its rows and the program's state after it (parameters,
Adam's moments) are copied to the host, and so are the rows of a sample
of the later dispatches drawn from the seed, each with the one after it.
Once the window has closed the reference follows the first dispatch from
the same seeded state on the same rows, and every kept row is looked up
in the set (``compare.py`` names the numbers).

Traced, the benchmark's spans wrap each batch the Trainer waits for
(``bench.input_wait``) and each dispatch (``bench.dispatch``, CUDA events
around it), and each epoch (``bench.epoch``).
"""

from __future__ import annotations

import gc
import hashlib
import random
import shutil
import tempfile
import time
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from benchmark import compare, scenes
from benchmark.harness import program_flags, training
from benchmark.reference import models as reference_models
from benchmark.reference.steps import plain_float32, train_steps
from benchmark.trace import Trace
from benchmark.weights import seeded_state

# later dispatches whose rows are kept: the first to start after each of
# this many seeded times in the window, and the one after it
SAMPLED_PAIRS = 3


def _digest(image: np.ndarray, mask: np.ndarray) -> bytes:
    return hashlib.blake2b(image.tobytes() + mask.tobytes(), digest_size=16).digest()


def _clone(state: Dict) -> Dict:
    return {k: ([t.detach().clone() for t in v] if isinstance(v, list) else v.detach().clone())
            for k, v in state.items()}


def build_trainer(ctx, packed_dir: str):
    from tpuseg_torch.configs import DatasetSourceConfig, load_config
    from tpuseg_torch.train.trainer import Trainer

    cfg = load_config(program_flags(ctx.config, ctx.workload))
    cfg.data.sources = (DatasetSourceConfig(kind="packed", packed_dir=packed_dir, weight=1.0),)
    cfg.data.seed = ctx.seed % 2 ** 31
    cfg.train.checkpoint_dir = ""
    cfg.train.history_file = "none"
    return Trainer(cfg, device=ctx.device)


def run(ctx) -> Dict:
    shape = training(ctx.config, ctx.workload)
    arch = ctx.config["reference"]
    dev = ctx.device
    if dev.type == "cuda":
        # the program's training entry point computes fp32 in fp32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    images, masks = scenes.make_scenes(ctx.workload["traffic"]["scenes"], shape["height"],
                                       shape["width"], arch["num_classes"],
                                       scenes.generator(ctx.seed, 0, dev), device=dev)
    images, masks = images.cpu().numpy(), masks.cpu().numpy()
    ctx.phase("scenes")
    packed = tempfile.mkdtemp(prefix="bench-scenes-")
    try:
        scenes.write_packed(packed, images, masks)
        ctx.phase("packed")
        return _run(ctx, packed, images, masks, arch, shape)
    finally:
        shutil.rmtree(packed, ignore_errors=True)


class HostCopies:
    """Pinned host buffers made in set-up, into which tensors of the window
    are copied on a side stream: what the check keeps takes no device
    memory and holds no step up."""

    def __init__(self, templates: List[torch.Tensor], dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)
                     for t in templates]
        self.stream = torch.cuda.Stream(dev) if self.cuda else None

    def take(self, tensors: List[torch.Tensor], hold: bool = False) -> List[torch.Tensor]:
        """Queue the copies behind the work queued so far; with ``hold``,
        the work queued next waits for them (for tensors written in place)."""
        if not self.cuda:
            for b, t in zip(self.bufs, tensors):
                b.copy_(t)
            return self.bufs
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            for b, t in zip(self.bufs, tensors):
                b.copy_(t, non_blocking=True)
                t.record_stream(self.stream)
        if hold:
            torch.cuda.current_stream().wait_stream(self.stream)
        return self.bufs

    def wait(self) -> None:
        if self.cuda:
            self.stream.synchronize()


def _state(trainer) -> Dict[str, Dict[str, torch.Tensor]]:
    """The program's parameters and Adam moments, by parameter name."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    opt = trainer.optimizer
    out = {"params": {n: p.detach() for n, p in trainer.model.named_parameters()}}
    for key in ("mu", "nu"):
        out[key] = {names[id(p)]: m.detach() for p, m in zip(opt.params, opt.state[key])}
    return out


def _record(trainer, ctx, shape, seconds: float) -> Dict:
    """Wrap the Trainer's dispatch: copy out the first dispatch's rows and
    the state after it, and the rows of a seeded sample of later ones."""
    step = trainer.train_step
    k, dev = shape["steps_per_dispatch"], ctx.device
    # [K, B, H, W(, 3)]; a single step's [B, ...] is copied in as K = 1
    rows = (k, shape["batch_size"], shape["height"], shape["width"])
    feeds = [HostCopies([torch.empty(rows + (3,), dtype=torch.uint8, device="meta"),
                         torch.empty(rows, dtype=torch.uint8, device="meta")], dev)
             for _ in range(1 + 2 * SAMPLED_PAIRS)]
    state = _state(trainer)
    names = {part: list(state[part]) for part in state}
    after_first = HostCopies([t for part in state for t in state[part].values()], dev)
    kept = {"fed": [], "copies": feeds + [after_first], "state": None}
    rng = random.Random(ctx.seed)
    marks = sorted(rng.uniform(0.0, seconds) for _ in range(SAMPLED_PAIRS))
    calls, follow, start = [0], [False], [0.0]

    def recording(imgs, msks):
        i = calls[0]
        calls[0] += 1
        if i == 0:
            start[0] = time.perf_counter()
        picked = bool(marks) and i > 0 and time.perf_counter() - start[0] >= marks[0]
        if picked:
            marks.pop(0)
        keep = i == 0 or follow[0] or picked
        follow[0] = picked
        if keep:
            kept["fed"].append(feeds[len(kept["fed"])].take([imgs, msks]))
        out = step(imgs, msks)
        if i == 0:
            now = _state(trainer)
            flat = after_first.take([now[part][name] for part in names for name in names[part]],
                                   hold=True)
            it = iter(flat)
            kept["state"] = {part: {name: next(it) for name in names[part]} for part in names}
        return out

    trainer.train_step = recording
    return kept


def _run(ctx, packed, images, masks, arch, shape) -> Dict:
    dev = ctx.device
    k, batch = shape["steps_per_dispatch"], shape["batch_size"]
    trainer = build_trainer(ctx, packed)
    ctx.phase("program built")
    with torch.device("meta"):
        reference = reference_models.build(arch, ctx.root)
    trainer.model.load_state_dict(seeded_state(reference, scenes.generator(ctx.seed, 1, dev), dev))
    start_model = _clone(trainer.model.state_dict())
    start_opt = _clone(trainer.optimizer.state_dict())
    cfg = trainer.cfg.train
    ctx.phase("weights")

    # warm-up: one dispatch, which runs the step eagerly and captures it
    cfg.steps_per_epoch = k
    trainer.train(epochs=trainer.epoch + 1)
    # the seeded state back in place for the window's first dispatch
    trainer.model.load_state_dict(start_model)
    trainer.optimizer.load_state_dict(start_opt)
    trainer.step = trainer.epoch = 0
    cfg.steps_per_epoch = 0             # the Trainer's own: one pass of the set
    ctx.phase("warm-up")

    trace = Trace(ctx.trace, dev)
    timing = {"waits": [], "dispatch": [], "steps": 0}
    if ctx.trace:
        _instrument(trainer, trace, timing, dev)
    seconds = trace.seconds(ctx.seconds)
    kept = _record(trainer, ctx, shape, seconds)
    n_before = len(trainer.step_losses)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with trace:
        setup_s = ctx.end_setup()
        t_start = time.perf_counter()
        with trace.window():
            while True:
                with trace.span("bench.epoch"):
                    trainer.train(epochs=trainer.epoch + 1)
                if time.perf_counter() - t_start >= seconds:
                    break
        window = time.perf_counter() - t_start
    losses = trainer.step_losses[n_before:]
    timing["steps"] = len(losses)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    for copies in kept["copies"]:
        copies.wait()
    fed = [(a.numpy(), b.numpy()) for a, b in kept["fed"]]
    state = kept["state"]

    del trainer, kept
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    program = {"losses": list(losses[:k]),
               **{part: {n: t.to(dev) for n, t in v.items()} for part, v in state.items()}}
    numbers = _check(program, fed, images, masks, reference, start_model, ctx, dev, shape)
    failed = int(sum(not np.isfinite(x) for x in losses))
    return {"metrics": {"train_images_per_s": len(losses) * batch / window, "setup_s": setup_s},
            "attempted": len(losses), "failed": failed, "numbers": numbers,
            "memory_peak_bytes": peak, "trace": trace.reading(), "timing": timing,
            "window_s": window, "shape": shape}


def _instrument(trainer, trace, timing, dev) -> None:
    """The traced run's spans and timers, wrapped around the Trainer's own
    calls on this instance."""
    step, batches = trainer.train_step, trainer.pipeline.train_batches
    k = trainer.steps_per_dispatch

    def dispatch(imgs, msks):
        with trace.span("bench.dispatch"):
            if dev.type != "cuda":
                return step(imgs, msks)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = step(imgs, msks)
            b.record()
            timing["dispatch"].append((a, b, k))
            return out

    def train_batches(n):
        inner = batches(n)
        try:
            while True:
                t = time.perf_counter()
                with trace.span("bench.input_wait"):
                    item = next(inner, None)
                if item is None:
                    return
                timing["waits"].append(time.perf_counter() - t)
                yield item
        finally:
            inner.close()

    trainer.train_step = dispatch
    trainer.pipeline.train_batches = train_batches


def _check(program, fed, images, masks, reference, start, ctx, dev, shape) -> Dict[str, float]:
    """The reference over the first dispatch's rows from the seeded state;
    every kept row looked up in the set."""
    where = {_digest(images[i], masks[i]): i for i in range(len(images))}
    foreign, batches, seen = 0, [], []
    for n, (stack_i, stack_m) in enumerate(fed):
        for imgs, msks in zip(stack_i, stack_m):
            rows = [where.get(_digest(a, b)) for a, b in zip(imgs, msks)]
            foreign += sum(r is None for r in rows)
            seen.append(tuple(rows))
            if n == 0:
                idx = [r if r is not None else 0 for r in rows]
                batches.append((torch.from_numpy(images[idx]).to(dev),
                                torch.from_numpy(masks[idx]).to(dev)))
    reference = reference.to_empty(device=dev)
    with plain_float32():
        ref = train_steps(reference, start, batches, shape["loss"], shape["lr"],
                          lovasz_weight=shape["lovasz_weight"])
    start_params = {n: start[n] for n in ref["params"]}
    numbers = compare.train_numbers(program, ref, start_params)
    numbers["rows_foreign"] = float(foreign)
    numbers["steps_repeated"] = float(sum(c - 1 for c in Counter(seen).values()))
    numbers["steps_kept"] = float(len(seen))
    if ctx.notes.get("keep_inputs"):
        # for the control and fault readings (``benchmark/calibrate.py``)
        ctx.notes["inputs"] = {"reference": reference, "start": start, "batches": batches,
                               "program": program, "fp32": ref}
    return numbers
