"""Serving traffic: one caller in a closed loop, ``Predictor.__call__`` on
batches of uint8 frames back to back for the window.

Set-up: a pool of frames at the cell's frame size is made on the device
from the seed and kept on the host (the caller's decoded frames); the
program's ``Predictor`` is built from the configuration's model flags at the
cell's model input size, with the nearest upscale on the device, TF32 off
as the program's serving entry point sets it. The seeded weights, their
BatchNorm running statistics settled on the pool's first batch as a
trained model's match its inputs (``reference.steps.settle_batchnorm``),
are copied into its model; two calls warm up and capture the pass. The window calls
the Predictor with the pool's batches in turn until ``--seconds`` have
passed, each call timed on the host clock from call to return. A sample of
the calls, drawn from the seed over all of them (a reservoir), keeps its
class maps; once the window has closed the reference recomputes each
sampled batch's logits, rounding where the configuration rounds
(``reference/lowp.py``), and every served pixel's class is held against
them.

Traced, the benchmark's spans wrap each call (``bench.call``) and each
device pass (``bench.pass``, CUDA events around the Predictor's captured
``_device_forward``).
"""

from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import scenes
from benchmark.compare import add_served, served_gaps, served_numbers
from benchmark.reference import models as reference_models
from benchmark.reference.lowp import rounding
from benchmark.reference.steps import plain_float32, serve_logits, settle_batchnorm
from benchmark.trace import Trace
from benchmark.weights import seeded_state


def build_predictor(ctx):
    from tpuseg_torch.configs import load_config
    from tpuseg_torch.infer.predictor import Predictor
    from benchmark.harness import program_flags

    traffic = ctx.workload["traffic"]
    cfg = load_config(program_flags(ctx.config, ctx.workload))
    return Predictor(cfg.model, input_hw=tuple(traffic["model_hw"]),
                     batch_size=traffic["batch_size"], upscale_on_host=False,
                     device=ctx.device)


def run(ctx) -> Dict:
    traffic = ctx.workload["traffic"]
    arch = ctx.config["reference"]
    dev = ctx.device
    b, (fh, fw), pool_n = traffic["batch_size"], traffic["frame_hw"], traffic["pool_batches"]
    if dev.type == "cuda":
        # the program's serving entry point computes fp32 in fp32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    frames, _ = scenes.make_scenes(pool_n * b, fh, fw, arch["num_classes"],
                                   scenes.generator(ctx.seed, 0, dev), device=dev)
    pool = frames.cpu().numpy().reshape(pool_n, b, fh, fw, 3)
    del frames
    ctx.phase("frames")
    predictor = build_predictor(ctx)
    ctx.phase("program built")
    with torch.device("meta"):
        reference = reference_models.build(arch, ctx.root)
    reference = reference.to_empty(device=dev)
    reference.load_state_dict(seeded_state(reference, scenes.generator(ctx.seed, 1, dev), dev))
    with plain_float32():
        settle_batchnorm(reference, torch.from_numpy(pool[0]).to(dev), traffic["model_hw"])
    state = {k: v.detach().clone() for k, v in reference.state_dict().items()}
    predictor.model.load_state_dict(state)
    ctx.phase("weights")
    for i in range(2):
        predictor(pool[i % pool_n])

    ctx.phase("warm-up")
    trace = Trace(ctx.trace, dev)
    timing: Dict[str, List] = {"calls": [], "passes": []}
    if ctx.trace:
        _instrument(predictor, trace, timing, dev)
    rng = random.Random(ctx.seed)
    keep = traffic["sample_batches"]
    sample: List = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    calls, failed = 0, 0
    seconds = trace.seconds(ctx.seconds)
    with trace:
        setup_s = ctx.end_setup()
        t_start = time.perf_counter()
        with trace.window():
            while True:
                batch = calls % pool_n
                t = time.perf_counter()
                with trace.span("bench.call"):
                    out = predictor(pool[batch])
                timing["calls"].append(time.perf_counter() - t)
                failed += int(out.shape != (b, fh, fw) or out.dtype != np.uint8)
                # reservoir sampling: every call equally likely to be kept
                if len(sample) < keep:
                    sample.append((batch, out))
                else:
                    j = rng.randrange(calls + 1)
                    if j < keep:
                        sample[j] = (batch, out)
                calls += 1
                if time.perf_counter() - t_start >= seconds:
                    break
        window = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del predictor
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    total: Dict = {}
    with plain_float32(), rounding(reference, ctx.config["compute_dtype"]):
        for batch, served in sample:
            logits = serve_logits(reference, torch.from_numpy(pool[batch]).to(dev),
                                  traffic["model_hw"])
            add_served(total, served_gaps(logits, torch.from_numpy(served).to(dev)))
    if ctx.notes.get("keep_inputs"):
        # for the control readings (``benchmark/calibrate.py``)
        ctx.notes["inputs"] = {"reference": reference, "pool": pool, "sample": sample}
    return {"metrics": {"serve_frames_per_s": calls * b / window, "setup_s": setup_s},
            "attempted": calls, "failed": failed,
            "numbers": served_numbers(total),
            "memory_peak_bytes": peak, "trace": trace.reading(), "timing": timing,
            "window_s": window}


def _instrument(predictor, trace, timing, dev) -> None:
    """CUDA events around the Predictor's captured pass, on this instance."""
    device_pass = predictor._device_forward

    def timed(frames, out_hw):
        with trace.span("bench.pass"):
            if dev.type != "cuda":
                return device_pass(frames, out_hw)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = device_pass(frames, out_hw)
            b.record()
            timing["passes"].append((a, b))
            return out

    predictor._device_forward = timed
