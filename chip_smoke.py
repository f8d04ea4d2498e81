#!/usr/bin/env python3
"""Drive the PyTorch port (tpuseg_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100, nvcc under
$CUDA_HOME or /usr/local/cuda, and PyTorch built for CUDA. Phases, each
printing one JSON line; any failure raises and exits nonzero:

1. device  — the card's name and count, and nvidia-smi's name/power limit;
2. build   — nvcc builds the six kernels from tpuseg_torch/csrc (one
             process each, in parallel) into build/kernels; ptxas's
             register, shared-memory and spill report;
3. kernels — each kernel against its plain PyTorch version at the serving
             and training paths' shapes (fused_inverted_residual at the
             encoder's 17 block shapes and two ragged ones), and timed
             (CUDA events over CUDA-graph replays, inputs rotated through
             more than 2x the 50 MB L2) beside the plain version and, where
             one PyTorch call computes the same function, that call (for
             the block, the port's eager InvertedResidual; for the
             decoder, cuDNN on channels_last views, the layout the port
             runs); the decoder, the block and upsample2x_argmax also
             repeat bit-equal; the decoder's error against a float64
             reference is at most twice the plain version's, the block's
             (mbconv_f64) is recorded beside the plain version's; and the
             launch floor (a one-element fill_ in the same graph timing)
             is timed beside upsample2x_argmax, whose bound lies below it;
4. serve   — the full-width mobilenetv2_unet (10 classes, 256x128, batch 8,
             --model.use_pallas=true --model.up_subpixel=false) served
             through the port's Predictor on 360x640 frames, with the launch
             counters proving the kernels ran, against a plain-path Predictor
             holding the same seeded weights;
5. head    — the model with upsample_head=False followed by the fused
             upsample2x_argmax kernel, against the full model's argmax;
5b. mbconv — the served flagship's 17 encoder-block inputs, captured with
             forward hooks on its served batches: fused_inverted_residual on
             each block's folded eval weights against the plain version and
             the eager block (no served path calls the kernel, as no JAX
             path calls the TPU one);
5c. families — mobilenetv2_fpn, mobilenetv2_deeplab, unet and light_unet
             at full width served through the Predictor with colorize on
             (argmax_colorize), against a Predictor with colorize off;
5d. stem_s2d — the flagship served with and without --model.stem_s2d on
             the same weights (the flag runs the plain stem conv: its JAX
             rewrite is exact), the same class maps;
5e. serve_options — the Predictor's serving options on the flagship:
             fetch_pack4 bit-equal to the default route; device_close's
             low bits bit-equal to the device route and its 0x80 plane to
             the native library's close of the road mask; preprocess_on_host
             bit-equal to the default route fed the host-resized frames
             (its agreement with the device resize reported); use_pallas
             with fetch_pack4 raises (ROADMAP C1); predict_async with the
             pinned fetch bit-equal to __call__;
5f. serve_ab — frames/s and p50 of six served routes (plain decoder with
             colorize off and on, the kernel route; the nearest upscale on
             the host and on the device), two rounds in turns;
5g. video  — VideoPipeline on 160 seeded 360x640 frames through the kernel
             route at depth 1 and 3: the stats line, the launches, and
             every frame's class map bit-equal to Predictor.__call__;
5h. http   — the port's HTTP server in-process at --max_batch 1 and 8: 200
             raw-codec requests from 8 client threads, each response
             against the direct Predictor, requests/s, p50 and p99;
5i. graphs — the port's captured steps (``tpuseg_torch/core/graphs.py``),
             under deterministic algorithms: the Trainer's captured train
             steps bit-equal to the same steps under ``graphs.eager()`` over
             3 steps, for --train.loss=lovasz (with and without remat) and
             for adamw + cosine warmup + grad_accum 2 + clip + EMA
             (parameters, BatchNorm statistics, optimizer state, EMA,
             generator; losses bit-equal, the Lovász value within its
             atomics' tolerance); the Trainer's flip+ms eval over a padded
             last batch equal to eager; steps_per_dispatch=4 equal to 8
             captured single steps; every serve_ab route and every HTTP
             bucket captured bit-equal to eager; the Predictor's graph cache
             held to MAX_GRAPHS keys with the memory of as many (16 frame
             sizes against 8). The launch counters, which a replay adds to,
             are held against the device's own kernel counts from
             torch.profiler: the two Lovász kernels over a 5-step
             profile_dir run, argmax_colorize and the decoder kernel over
             the kernel route's served batches. Then eager against
             captured: the train p50 step and its stages at
             steps_per_dispatch 1 and 4, the serve device stage and frames/s
             (in turns: eager, captured, captured, eager), the profiled
             run's top device operations, and the FLOPs of a train step and
             a served forward with their fp32 bound;
6. train   — the full-width mobilenetv2_unet trained through
             ``tpuseg_torch.main`` with --train.loss=lovasz (256 bins, batch
             8, 256x128, Adam 1.5e-4, augment on, synthetic scenes): the
             loss falls, a val mIoU is computed, both Lovász kernels launch
             once per step, a checkpoint round-trips; then steady step
             times, the step's stages, and a 3-step A/B of the kernel loss
             against one built on the plain versions, under deterministic
             algorithms: the replayed steps' gradients (read after each
             replay) and the final parameters bit-equal;
7. train_packed — 1024 synthetic scenes packed at 256x128 with
             ``tpuseg_torch.tools.pack_dataset`` (every packed sample
             bit-equal to the source; the native gather loaded, a batch of
             it into pinned buffers bit-equal to numpy's), then the same
             model trained from the packed directory through
             ``tpuseg_torch.main`` with --data.heavy_augment=true
             --train.loss=ce+lovasz --train.class_weights=auto (80 steps,
             a val split): both Lovász kernels launch once per step, the
             loss falls (last 10 below first 10), a val mIoU is recorded,
             the resolved weights equal resolve_auto_class_weights over the
             Trainer's own split; a carla source with cv2 refused raises
             naming the packed route; the stages (one-gather host batch,
             upload, the heavy augment eager and alone, the captured step)
             and the steady p50 step and images/s beside the train phase's
             synthetic ones; 3 captured steps with the heavy augment
             bit-equal to 3 under ``graphs.eager()`` (deterministic
             algorithms; the Lovász value within its atomics' tolerance);
7b. train_contact — the training path as a user of the JAX package runs
             it, from the same packed scenes, the flagship at 10 classes,
             256x128, batch 8: (1) a full-width torchvision-named
             mobilenet_v2 state_dict made from a seed through
             ``tpuseg_torch.tools.import_pretrained`` (the encoder equal to
             its source, the decoder to the seeded init); (2) 40 captured
             steps of --train.qat=true --train.loss=lovasz from it (the loss
             falls, both Lovász kernels once a step, 61 QAT convs, the
             state_dict's keys and shapes as without QAT, fake_quant_act and
             fake_quant_kernel on every QAT conv's input and weight
             bit-equal card against CPU, 3 captured steps bit-equal to
             eager), timed in turns against plain Lovász training with the
             subpixel and with the materialized decoder; (3) 40 captured
             steps of a mobilenetv2_fpn student distilled from that run's
             checkpoint (alpha 0.5, T 2: the loss falls, the in-step teacher
             logits bit-equal to an eval forward of the teacher, 3 captured
             steps bit-equal to eager), timed in turns against the student
             alone, with the teacher forward's device time and share;
             (4) ``tpuseg_torch.tools.eval_miou`` on the QAT checkpoint
             (64 synthetic scenes) equal to the Trainer's own evaluate of
             it (the same confusion matrix), with its images/s; (5) 3 steps
             of QAT and distillation over two ranks sharing the card over
             gloo: every QAT conv's activation scale on both ranks equal,
             bit for bit, to the scale over the global batch that one
             process takes (the max of the ranks' absmaxes), the parameters
             bit-equal across ranks;
8. mesh    — data parallelism: two ranks started by
             ``tpuseg_torch.core.mesh.launch_local`` on the card over gloo
             (with a card per rank, NCCL): the sharded Lovász on each
             rank's 4 rows of [8,128,256,10] against the one-process
             kernel route (coefficients bit-equal, value within 1e-4,
             gradient within 1e-6) and the plain sharded version, one
             launch of each kernel per call, its timings (the region with
             its staged all_reduce, the all_reduce, the local part); the
             flagship trained 20 steps through ``tpuseg_torch.main
             --mesh.data=2 --train.loss=ce+lovasz`` (the loss falls, the
             parameters bit-equal across ranks, 20 launches per rank, the
             p50 step labelled with its route), then 3 eager steps of a
             world-2 Trainer against one process on the same batches (the
             first loss and BatchNorm statistics; the first step's
             gradients as summed across the ranks, per parameter, and the
             same check failing on them doubled; the parameters within
             Adam's bound; the later losses).

9. bf16    — ModelConfig.compute_dtype=bfloat16 (the JAX package's bf16
             policy): (a) the four kernels that take activations or logits
             on bf16 inputs at the slice's shapes, each against its plain
             version and the f32 route on the widened inputs (the decoder's
             f32 output and the block's bf16 one bit-equal to that route,
             the decoder within the fp32 tolerance of its plain version,
             the block within 1e-4 before rounding or a bf16 step after,
             the two argmax kernels bit-equal), timed beside the fp32 rows
             (the decoder's library call both as cuDNN fp32 over the widened
             concat, the same function, and as cuDNN bf16, for context);
             (b) the full-width flagship served in bf16 on the kernel route
             (4 decoder launches a batch) and the default route, each
             route's captured class maps bit-equal to its eager ones and
             agreeing with a bf16 plain-path Predictor's on
             BF16_SERVED_AGREE of the pixels, its logits within
             BF16_LOGIT_TOL of that Predictor's and its picks equal where
             no pick can flip (the agreement above BF16_MARGIN, and that
             with fp32, reported), frames/s, p50 and the captured device
             stage against fp32 in turns; (c) ``tpuseg_torch.main
             --model.compute_dtype=bfloat16 --train.loss=lovasz`` for 40
             steps (the loss falls, both Lovász kernels once a step), 3
             captured steps bit-equal to eager, the p50 beside the train
             phase's and the device step against fp32 in turns; (d) 5 steps
             each with --train.mu_dtype=bfloat16 and --train.grads_bf16=true
             (mu bf16, nu and the parameters fp32, finite losses). Its
             path launches join the summary's counts.
9b. spatial — the spatially sharded train step, after mesh: the Lovász
             kernels at one rank's slab [10, 131,072] (another plan than
             the whole batch's) against their plain versions; two ranks
             (as mesh_route places them) train the full-width flagship 20
             steps from the packed set through ``tpuseg_torch.main
             --mesh.data=1 --mesh.spatial=2 --train.loss=ce+lovasz`` (64-row
             slabs of the 256x128 frame; the loss falls, 20 launches of each
             Lovász kernel per rank, uncaptured), then per rank the p50 step
             on the host clock, the sharded Lovász region, the row fetches'
             time (synchronized timers around each fetch) and, on the last
             of 3 eager A/B steps, the activation peak against one
             process's at batch 8 (at most SPATIAL_MEMORY_RATIO); those 3
             steps against one process on the same batches: step 1's
             train-mode logits assembled from the slabs within
             SPATIAL_LOGITS_TOL of their largest magnitude, the loss within
             SPATIAL_LOSS_RTOL, the summed gradients within the mesh
             phase's 5% (and the same check failing on them doubled), every
             rank bit-equal; the same 3 steps at data 2 x spatial 2 on four
             ranks, with the same checks.
10. export — quantize and export, on the serve phase's seeded
             flagship weights, plain decoder: (1) calibration on the card
             (8 batches of 8 synthetic scenes, 61 convs), every calibrated
             conv's int32 sums bit-equal to the plain float64 version on
             the served frames' own int8 inputs (each conv timed alone,
             int8 against cuDNN fp32; the int8 and fp32 forwards' device
             time); (2) ``tpuseg_torch.convert --export.format=quantized``
             in-process, its directory served by the Predictor in int8 with
             colorize on (argmax_colorize once a batch, captured maps
             bit-equal to eager ones, the whole int8 forward bit-equal to
             the same forward on the plain int8 convs, agreement with fp32
             printed, timed in turns against fp32); (3)
             ``--export.format=stablehlo --export.fold_bn=false``, a
             torch.export program with a symbolic batch, its logits within
             rel 1e-5 of the live model at batch 2 and 8, served through
             ``Predictor(artifact=)`` (maps >= 99.9% of the live
             Predictor's, timed in turns); the convert default (BatchNorm
             folded) and the fp16 artifact (it stores fp16); (4)
             ``--export.format=onnx`` and ``run_model`` on the card
             (check_model empty, maps >= 99.9% of the live model's); (5)
             ``tpuseg_torch.tools.eval_quantized`` on 64 scenes (every
             variant present, bn_folded agreement >= 0.999); (6)
             ``--export.format=savedmodel``, which needs TensorFlow: on the
             card's host, which has none, exit 1 naming it and nothing
             written (where TF imports, exit 0, valid). On the seeded
             weights fp32 rounding moves logits by 1e-5-1e-4 between two
             computations of the same function and int8 maps agree with
             fp32 on ~60%, so convert's bounds (int8 agreement 0.9, round
             trips 1e-5 and fp16 1e-2) and eval_quantized's 1-point verdict
             fail there in both packages: each verdict is recorded as the
             tool's finding, not held as a check of the port. Its
             argmax_colorize launches join the summary's counts.
11. ablate — the flagship's per-stage device times:
             ``tpuseg_torch.tools.ablate_forward`` at its defaults (bf16,
             batch 64, 512x512, chain 16) with the subpixel decoder and the
             materialized one, ``ablate_train`` at its defaults (bf16,
             batch 64, 256x128, chain 8) and in fp32; each row one CUDA
             graph replayed between CUDA events; the rows, their deltas
             and images/s; every row's captured value bit-equal to the
             same prefix run under ``graphs.eager()`` (deterministic
             algorithms; ``full``, the real train step, as 3 captured steps
             against 3 eager ones from the same seed: losses and the whole
             state_dict bit-equal);
12. sweep  — the two Lovász kernels against their plain versions at
             the protocol's [10, 64*128*256] (8x batch 8's pixels a
             block), then ``tpuseg_torch.tools.convergence_sweep`` on a
             two-row grid (ce, lovasz) at --epochs 1 on the protocol's
             base config (bf16, batch 64, 2276 synthetic scenes, 8 steps a
             dispatch), counted from 0: both records ok with a finite val mIoU, each Lovász kernel
             launched once a step of the lovasz run and never in the ce
             run (its launches join the summary's counts), then the same
             command again skipping both runs.

The port's ``first_contact``, ``export_synthetic_dataset`` and
``make_demo_video`` tools read or write image and video files with cv2,
which the card's host does not have; no phase runs them (their CPU tests
do, where cv2 is).

The serving phases run as on a host without cv2, the path the port is
built for: a meta-path finder refuses cv2 for the whole run (the device
line says whether the host has it), so preprocessing runs on the numpy
INTER_LINEAR replica and the postprocess on the native library, with car
boxes off.

Then the kernels summary line, nvidia-smi's line, and, last, the result
line {"ok": true, "device": {...}}. A kernel's ``launches`` there are its
launches on the serving (serve and video phases) or training path (train,
train_packed, train_contact's QAT and distilled runs and its 3 steps on
each rank, the mesh phase's 20 steps on each rank, the spatial phase's
20 steps on each of its two ranks and 3 on each of its four, and the
sweep's lovasz run);
fused_inverted_residual runs on
no path, so it shows 0 and, as ``check_launches``, the mbconv phase's. Without a CUDA device, or without the
tpuseg_torch package beside this file, it exits nonzero and prints no
result. fp32 comparisons run with TF32 off for both cuDNN and matmul. The
summary gives each of the four bf16 kernels its ``bf16_*`` fields beside
the fp32 ones.

Every train step, eval step and served batch of the port runs as a replay
of a captured CUDA graph, so each phase above runs the captured route; a
phase that needs an eager forward (the mbconv phase's hooks) says so with
``graphs.eager()``. Launch counts stay per call: a capture's launches are
added at every replay, not at the capture.
"""

from __future__ import annotations

import contextlib
import importlib.abc
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.configs import load_config
from tpuseg_torch.core import graphs
from tpuseg_torch.core.prng import make_generator
from tpuseg_torch.core.weights import init_weights
from tpuseg_torch.data.augment import normalize_images
from tpuseg_torch.data.class_maps import COLOR_MAP_BGR
from tpuseg_torch.infer.predictor import Predictor
from tpuseg_torch.models.blocks import nchw, nhwc
from tpuseg_torch.models.mobilenetv2 import (BlockShape, InvertedResidual, MobileNetV2Encoder,
                                             inverted_residual_shapes)
from tpuseg_torch.models.registry import build_model
from tpuseg_torch.ops import _build, kernels
from tpuseg_torch.ops.mbconv import (fold_inverted_residual, fused_inverted_residual,
                                     mbconv_plain)
from tpuseg_torch.ops.resize import (resize_bilinear, resize_nearest_host,
                                     upsample2x_bilinear)

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth, fp32
# outside the tensor cores, and TF32 on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12
# the decoder's and the block's exact-fp32 route: each fp32 product is three
# TF32 products (big*big + big*small + small*big) on the tensor cores
TC_ROUTE = "3xTF32 mma.sync m16n8k8 on the tensor cores: 3 TF32 products per fp32 term"
MBCONV_ROUTE = ("3xTF32 mma.sync for the two 1x1 products (3 TF32 products per fp32 term "
                "at 495 TFLOP/s) plus the depthwise FMAs on the CUDA cores at 67 TFLOP/s")
L2_BYTES = 50 * 2**20

BATCH, MODEL_HW, FRAME_HW, CLASSES, SEED = 8, (128, 256), (360, 640), 10, 0
SERVE_BATCHES, TIMED_BATCHES = 3, 20
VIDEO_FRAMES, HTTP_REQUESTS, HTTP_CLIENTS = 160, 200, 8
NEAR_TIE = 1e-5           # logit margin under which two argmax picks may differ
UPCONCAT_ATOL = UPCONCAT_RTOL = 1e-4   # fp32 sums of up to 12,096 terms, other order

REPLACES = {
    "argmax_colorize": "tpuseg/ops/pallas_kernels.py:63",
    "upsample2x_argmax": "tpuseg/ops/pallas_kernels.py:165",
    "fused_upsample_concat_conv": "tpuseg/ops/pallas_kernels.py:314",
    "lovasz_histograms": "tpuseg/ops/lovasz_pallas.py:124",
    "lovasz_lookup": "tpuseg/ops/lovasz_pallas.py:170",
    "fused_inverted_residual": "tpuseg/ops/pallas_mbconv.py:136",
}
SOURCES = {
    "argmax_colorize": "tpuseg_torch/csrc/argmax_colorize.cu",
    "upsample2x_argmax": "tpuseg_torch/csrc/upsample2x_argmax.cu",
    "fused_upsample_concat_conv": "tpuseg_torch/csrc/upconcat_conv.cu",
    "lovasz_histograms": "tpuseg_torch/csrc/lovasz_histograms.cu",
    "lovasz_lookup": "tpuseg_torch/csrc/lovasz_lookup.cu",
    "fused_inverted_residual": "tpuseg_torch/csrc/mbconv.cu",
}
# the Lovász planes of one training batch: [C, B*H*W] = [10, 262,144]
LOVASZ_SHAPE = (CLASSES, BATCH * MODEL_HW[0] * MODEL_HW[1])
# error-sum histogram: f32 sums of up to 2.6e5 errors per bin, taken in
# another order (shared-memory atomics vs scatter_add_), relative per bin
ERRSUM_RTOL = 1e-4
# the loss value: sum over bins of error-sum x coefficient, |coef| <= 1,
# so the error-sum tolerance carries over to about 1e-4 of a value <= 1
LOVASZ_VALUE_ATOL = 1e-4
TRAIN_STEPS, VAL_SPLIT, TIMED_STEPS, AB_STEPS = 80, 0.0625, 30, 3
# the train_packed phase: 1024 synthetic scenes packed at 256x128 (128 MiB),
# trained with the heavy augment, CE + Lovász and auto class weights
PACKED_SAMPLES = 1024
PACKED_FLAGS = ["--data.heavy_augment=true", "--train.loss=ce+lovasz",
                "--train.class_weights=auto"]
ROOT = Path(__file__).resolve().parent
# decoder up blocks at batch 8, 256x128 input: (skip [B,2H,2W,Cs], x [B,H,W,Cx], Cout)
UPCONCAT_SHAPES = {
    "up1": ((BATCH, 8, 16, 64), (BATCH, 4, 8, 1280), 256),
    "up2": ((BATCH, 16, 32, 32), (BATCH, 8, 16, 256), 128),
    "up3": ((BATCH, 32, 64, 24), (BATCH, 16, 32, 128), 64),
    "up4": ((BATCH, 64, 128, 16), (BATCH, 32, 64, 64), 32),
}
# the encoder's 17 inverted-residual blocks at batch 8 and a 256x128 input,
# read off a full-width encoder; then odd H at stride 2 and a W that the
# kernel's 8-wide tile does not divide
MBCONV_BLOCKS = inverted_residual_shapes(MobileNetV2Encoder(), *MODEL_HW)
MBCONV_RAGGED = [BlockShape(16, 96, 24, 2, False, True, 9, 13),
                 BlockShape(24, 144, 24, 1, True, True, 8, 11)]
# fp32 sums of up to 960 terms (the project over hidden) taken in another
# order than cuBLAS's and cuDNN's: about 1e-5 of values up to ~30 expected
MBCONV_ATOL = MBCONV_RTOL = 1e-4
FAMILIES = ("mobilenetv2_fpn", "mobilenetv2_deeplab", "unet", "light_unet")
# stem_s2d serves the same plain stem conv (its JAX rewrite is exact), so
# the logits are expected bit-equal; 1e-6 leaves room for cuDNN choosing
# another algorithm for the second model
S2D_ATOL = S2D_RTOL = 1e-6



def cv2_installed() -> bool:
    """Whether the host has cv2 at all (asked before the finder goes in)."""
    try:
        return importlib.util.find_spec("cv2") is not None
    except ImportError:
        return False



def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_FP32_PER_S):
    """(least time in ms, what sets it) against the published peaks: the
    bytes at the HBM rate or ``n_ops`` at ``peak_ops``, whichever is longer."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def device_ms(fn, inputs, replays: int = 20) -> float:
    """Device time of one ``fn(*args)`` call in ms: one call per input set
    captured into a CUDA graph (the input sets together exceed the L2, so
    each call finds its inputs cold), replayed ``replays`` times between
    CUDA events."""
    for args in inputs:                      # warm-up: builds, cuDNN plans, caches
        fn(*args)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with graphs.no_collection(), torch.cuda.stream(stream), torch.cuda.graph(graph,
                                                                             stream=stream):
        for args in inputs:
            fn(*args)
    torch.cuda.synchronize()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(inputs))


def copies(make, n_bytes: int):
    """Enough independent input sets (from ``make(i)``) to exceed 2x the L2."""
    n = max(2, min(32, math.ceil(2 * L2_BYTES / n_bytes)))
    return [make(i) for i in range(n)]


def randn(shape, seed, scale=1.0):
    g = make_generator(seed, "cuda")
    return torch.randn(shape, generator=g, device="cuda") * scale


def below_max(logits: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    """Per pixel, how far the picked class's logit lies below the maximum."""
    top = logits.max(dim=-1).values
    return top - logits.gather(-1, picked.long().unsqueeze(-1)).squeeze(-1)


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    t = logits.topk(2, dim=-1).values
    return t[..., 0] - t[..., 1]


class RefuseCv2(importlib.abc.MetaPathFinder):
    """Refuses ``import cv2``: the run takes the routes of a host without it."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "cv2":
            raise ImportError("cv2 refused by chip_smoke.py")
        return None


def phase_device(has_cv2: bool):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "cv2_installed": has_cv2, "cv2": "refused for this run",
            "nvcc": [ln for ln in subprocess.run(
                [_build.nvcc_path(), "--version"], capture_output=True, text=True,
                check=True, timeout=60).stdout.splitlines() if "release" in ln][0]}
    emit(info)
    return info


def phase_build():
    for name in _build.SOURCES:          # build from the checkout's sources now
        _build.lib_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    built = _build.build()
    wall = time.perf_counter() - t0
    report = {
        name: {"nvcc_s": round(b.seconds, 2),
               "ptxas": [ln.strip() for ln in b.ptxas.splitlines()
                         if "Used" in ln or "spill" in ln]}
        for name, b in built.items()
    }
    emit({"phase": "build", "wall_s": round(wall, 2), "kernels": report})


def upconcat_f64(skip, x, w, b) -> torch.Tensor:
    """conv3x3(cat([skip, up2x(x)])) + b in float64 throughout, NHWC: the
    reference that the kernel's and the plain version's fp32 errors are
    measured against (``fused_upconcat_plain`` itself computes in fp32)."""
    up = upsample2x_bilinear(x.double(), align_corners=False)
    cat = torch.cat([skip.double(), up], dim=-1).permute(0, 3, 1, 2)
    y = F.conv2d(cat, w.double().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1) + b.double()


def mbconv_f64(x, we, se, be, wd, sd, bd, wp, sp, bp, stride=1, use_res=False):
    """The block in float64 throughout, NHWC: the reference that the
    kernel's and the plain version's fp32 errors are measured against
    (``mbconv_plain`` itself computes in fp32)."""
    d = lambda t: t.double()
    y = d(x)
    if we is not None:
        y = (y @ d(we) * d(se) + d(be)).clamp(0.0, 6.0)
    h, w = y.shape[1], y.shape[2]
    ho, wo = h // stride, w // stride
    yp = F.pad(y, (0, 0, 1, 1, 1, 1))
    acc = sum(yp[:, dy:dy + h:stride, dx:dx + w:stride][:, :ho, :wo] * d(wd)[dy, dx]
              for dy in range(3) for dx in range(3))
    out = (acc * d(sd) + d(bd)).clamp(0.0, 6.0) @ d(wp) * d(sp) + d(bp)
    return out + d(x) if use_res else out


def launch_floor_ms() -> float:
    """The least device time of one kernel in device_ms's timing: a
    one-element fill_, captured and replayed as the kernels are."""
    return device_ms(lambda t: t.fill_(1.0), [(torch.empty(1, device="cuda"),)
                                               for _ in range(32)])


def phase_kernels():
    """Each kernel vs its plain version at the path's shapes, and timings."""
    out = {}

    # -- argmax_colorize at [8,128,256,10]
    shape = (BATCH, *MODEL_HW, CLASSES)
    logits = randn(shape, 1)
    cls_k, col_k = kernels.argmax_colorize(logits, COLOR_MAP_BGR)
    cls_p, col_p = kernels.argmax_colorize_plain(logits, COLOR_MAP_BGR)
    torch.cuda.synchronize()
    if not (torch.equal(cls_k, cls_p) and torch.equal(col_k.view(torch.int32),
                                                      col_p.view(torch.int32))):
        raise AssertionError("argmax_colorize disagrees with its plain version")
    n_pix = BATCH * MODEL_HW[0] * MODEL_HW[1]
    n_bytes = n_pix * CLASSES * 4 + n_pix * 5 + CLASSES * 4
    ins = copies(lambda i: (randn(shape, 100 + i),), n_pix * CLASSES * 4)
    words = kernels._words_for(COLOR_MAP_BGR, logits.device)
    out["argmax_colorize"] = dict(
        max_abs_err=float(below_max(logits, cls_k).max()),
        ms=device_ms(lambda x: kernels.argmax_colorize(x, COLOR_MAP_BGR), ins),
        plain_ms=device_ms(lambda x: kernels.argmax_colorize_plain(x, COLOR_MAP_BGR), ins),
        library_ms=device_ms(lambda x: words[torch.argmax(x, dim=-1)], ins),
        library="torch.argmax + palette index",
        shape=list(shape))
    out["argmax_colorize"]["bound_ms"], out["argmax_colorize"]["bound_by"] = bound_ms(
        n_bytes, n_pix * (CLASSES - 1))

    # -- upsample2x_argmax at [8,64,128,10] -> [8,128,256]
    shape = (BATCH, MODEL_HW[0] // 2, MODEL_HW[1] // 2, CLASSES)
    logits = randn(shape, 2)
    got = kernels.upsample2x_argmax(logits)
    again = kernels.upsample2x_argmax(logits)
    want = kernels.upsample2x_argmax_plain(logits)
    up = upsample2x_bilinear(logits, align_corners=True)
    near = top2_margin(up) < NEAR_TIE
    differ = got != want
    # the same taps, rounding order and strict '>' as the plain version
    if bool(differ.any()) or not torch.equal(got, again):
        raise AssertionError(f"upsample2x_argmax: {int(differ.sum())} pixels differ from the "
                             "plain version, or repeated calls differ")
    n_out = BATCH * MODEL_HW[0] * MODEL_HW[1]
    n_in = math.prod(shape)
    ins = copies(lambda i: (randn(shape, 200 + i),), n_in * 4)
    lib_ins = [(x.permute(0, 3, 1, 2).contiguous(),) for (x,) in ins]
    out["upsample2x_argmax"] = dict(
        max_abs_err=float(below_max(up, got).max()),
        near_ties=int(near.sum()), mismatches=int(differ.sum()), bit_equal=True,
        repeat_bit_equal=True,
        ms=device_ms(kernels.upsample2x_argmax, ins),
        launch_floor_ms=launch_floor_ms(),
        plain_ms=device_ms(kernels.upsample2x_argmax_plain, ins),
        library_ms=device_ms(lambda x: F.interpolate(
            x, scale_factor=2, mode="bilinear", align_corners=True).argmax(1), lib_ins),
        library="F.interpolate(bilinear, align_corners=True).argmax(1)",
        shape=list(shape))
    out["upsample2x_argmax"]["bound_ms"], out["upsample2x_argmax"]["bound_by"] = bound_ms(
        n_in * 4 + n_out, n_out * CLASSES * 7)

    # -- fused_upsample_concat_conv at the four decoder shapes
    per_shape = {}
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_fp32_ms=0.0)
    max_err = 0.0
    for k, (sshape, xshape, cout) in UPCONCAT_SHAPES.items():
        cin = sshape[-1] + xshape[-1]

        def make(i, sshape=sshape, xshape=xshape, cin=cin, cout=cout):
            return (randn(sshape, 300 + 4 * i), randn(xshape, 301 + 4 * i),
                    randn((3, 3, cin, cout), 302 + 4 * i, 0.05),
                    randn((cout,), 303 + 4 * i, 0.1))

        skip, x, w, b = make(0)
        got = kernels.fused_upsample_concat_conv(skip, x, w, b)
        again = kernels.fused_upsample_concat_conv(skip, x, w, b)
        want = kernels.fused_upconcat_plain(skip, x, w, b)
        err = (got - want).abs()
        if bool((err > UPCONCAT_ATOL + UPCONCAT_RTOL * want.abs()).any()):
            raise AssertionError(f"fused_upsample_concat_conv {k}: max err {float(err.max())}")
        if not torch.equal(got, again):
            raise AssertionError(f"fused_upsample_concat_conv {k}: repeated calls differ")
        max_err = max(max_err, float(err.max()))
        ref64 = upconcat_f64(skip, x, w, b)
        err64 = float((got.double() - ref64).abs().max())
        plain_err64 = float((want.double() - ref64).abs().max())
        if err64 > 2 * plain_err64:
            raise AssertionError(f"fused_upsample_concat_conv {k}: {err64} off f64, more "
                                 f"than twice the plain version's {plain_err64}")
        n_bytes = 4 * (math.prod(sshape) + math.prod(xshape) + 9 * cin * cout + cout
                       + math.prod(sshape[:3]) * cout)
        flops = 2 * math.prod(sshape[:3]) * cout * 9 * cin
        ins = copies(make, n_bytes)
        # the layout the port runs: channels_last views of the NHWC tensors,
        # and the weight as a channels_last nn.Conv2d holds it
        lib_ins = [(s.permute(0, 3, 1, 2), xx.permute(0, 3, 1, 2),
                    ww.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), bb)
                   for s, xx, ww, bb in ins]
        row = dict(
            shape=[list(sshape), list(xshape), cout], max_abs_err=float(err.max()),
            max_abs_err_vs_f64=err64, plain_max_abs_err_vs_f64=plain_err64,
            repeat_bit_equal=True,
            ms=device_ms(kernels.fused_upsample_concat_conv, ins),
            plain_ms=device_ms(kernels.fused_upconcat_plain, ins),
            library_ms=device_ms(lambda s, xx, ww, bb: F.conv2d(torch.cat(
                [s, F.interpolate(xx, scale_factor=2, mode="bilinear", align_corners=False)],
                dim=1), ww, bb, padding=1), lib_ins),
            gflop=flops / 1e9)
        row["bound_fp32_ms"], _ = bound_ms(n_bytes, flops)
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 3 * flops, PEAK_TF32_PER_S)
        per_shape[k] = row
        for key in tot:
            tot[key] += row[key]
    out["fused_upsample_concat_conv"] = dict(
        max_abs_err=max_err, **tot, bound_tc_ms=tot["bound_ms"],
        bound_by=("operations" if all(r["bound_by"] == "operations" for r in per_shape.values())
                  else "bytes"),
        bound_tc_route=TC_ROUTE,
        bound_fp32_route="exact fp32 FMA on the CUDA cores at 67 TFLOP/s",
        library="F.conv2d(cat([skip, F.interpolate(x)])) on channels_last views "
                "(cuDNN, TF32 off)",
        per_call=per_shape, note="ms are sums over the four up blocks of one forward")
    out.update(lovasz_rows())
    out["fused_inverted_residual"] = mbconv_row()
    emit({"phase": "kernels", **out})
    return out


def lovasz_planes(seed: int, p: int = LOVASZ_SHAPE[1]):
    """(errors, fg), each f32 [C, p] contiguous, as one training batch gives
    them: |onehot - softmax| of seeded logits against seeded labels, with
    257 pixels at e = 1.0 exactly on their label's class (and 0 on the
    others) and 43 more at e = 0 on every class."""
    c = LOVASZ_SHAPE[0]
    g = make_generator(seed, "cuda")
    logits = torch.randn((p, c), generator=g, device="cuda") * 2.0
    labels = torch.randint(0, c, (p,), generator=g, device="cuda")
    fg = F.one_hot(labels, c).to(torch.float32)
    errors = (fg - logits.softmax(dim=-1)).abs()
    errors[:257] = fg[:257]
    errors[257:300] = 0.0
    return errors.t().contiguous(), fg.t().contiguous()


def lovasz_rows():
    """lovasz_histograms and lovasz_lookup at [10, 262,144] against their
    plain versions: counts, fg sums and w bit-equal, error sums within
    ERRSUM_RTOL, the autograd op's value within LOVASZ_VALUE_ATOL and its
    gradient bit-equal; then timed."""
    from tpuseg_torch.ops import lovasz

    c, p = LOVASZ_SHAPE
    e, fg = lovasz_planes(400)
    hk = lovasz.lovasz_histograms(e, fg)
    again = lovasz.lovasz_histograms(e, fg)
    hp = lovasz.lovasz_histograms_plain(e, fg)
    h64 = lovasz.lovasz_histograms_plain(e.double(), fg.double())
    torch.cuda.synchronize()
    if not (torch.equal(hk[0], hp[0]) and torch.equal(hk[1], hp[1])):
        raise AssertionError("lovasz_histograms: counts or fg sums differ from the plain version")
    if not (torch.equal(hk[0], again[0]) and torch.equal(hk[1], again[1])):
        raise AssertionError("lovasz_histograms: repeated calls give other counts or fg sums")
    s_err = (hk[2] - hp[2]).abs()
    if bool((s_err > ERRSUM_RTOL * h64[2].abs() + 1e-7).any()):
        raise AssertionError(f"lovasz_histograms: error sums off by {float(s_err.max())}")

    def rel64(h):
        return float(((h.double() - h64[2]).abs() / h64[2].abs().clamp(min=1e-30)).max())

    coef, _ = lovasz.coefficients(*hp)
    wk = lovasz.lovasz_lookup(e, coef)
    wp = lovasz.lovasz_lookup_plain(e, coef)
    torch.cuda.synchronize()
    if not torch.equal(wk, wp):
        raise AssertionError("lovasz_lookup disagrees with its plain version")

    ek, ep = e.clone().requires_grad_(True), e.clone().requires_grad_(True)
    vk, vp = lovasz.lovasz_binned_kernel(ek, fg), lovasz.lovasz_binned_plain(ep, fg)
    (vk + vp).backward()
    torch.cuda.synchronize()
    value_err = abs(float(vk.detach()) - float(vp.detach()))
    if value_err > LOVASZ_VALUE_ATOL or not torch.equal(ek.grad, ep.grad):
        raise AssertionError(f"Lovász op: value off by {value_err}, or gradients differ")

    plane = c * p * 4
    hist_ins = copies(lambda i: lovasz_planes(500 + i), 2 * plane)
    look_ins = copies(lambda i: (lovasz_planes(600 + i)[0], coef), plane)
    rows = {
        "lovasz_histograms": dict(
            max_abs_err=float(s_err.max()), counts_fg_bit_equal=True,
            repeat_counts_fg_bit_equal=True,
            errsum_max_rel_vs_f64=rel64(hk[2]), plain_errsum_max_rel_vs_f64=rel64(hp[2]),
            value=float(vk.detach()), plain_value=float(vp.detach()), value_abs_err=value_err,
            ms=device_ms(lovasz.lovasz_histograms, hist_ins),
            plain_ms=device_ms(lovasz.lovasz_histograms_plain, hist_ins),
            library_ms=None, library="none: no one PyTorch call gives the three histograms",
            shape=list(LOVASZ_SHAPE)),
        "lovasz_lookup": dict(
            max_abs_err=float((wk - wp).abs().max()), w_bit_equal=True,
            grad_bit_equal=True,
            ms=device_ms(lovasz.lovasz_lookup, look_ins),
            plain_ms=device_ms(lovasz.lovasz_lookup_plain, look_ins),
            library_ms=None, library="none: no one PyTorch call bins and gathers",
            shape=list(LOVASZ_SHAPE)),
    }
    # bytes: each input read once, each output written once; operations:
    # 3 adds per pixel (histograms), one select per pixel (lookup)
    rows["lovasz_histograms"]["bound_ms"], rows["lovasz_histograms"]["bound_by"] = bound_ms(
        2 * plane + 3 * c * 256 * 4, 3 * c * p)
    rows["lovasz_lookup"]["bound_ms"], rows["lovasz_lookup"]["bound_by"] = bound_ms(
        2 * plane + c * 256 * 4, c * p)
    return rows


def mbconv_block(shape: BlockShape, seed: int):
    """A port InvertedResidual of ``shape`` on the card in eval, seeded
    weights and random BatchNorm statistics, and its folded kernel
    arguments."""
    block = InvertedResidual(shape.cin, shape.cout, shape.stride, shape.hidden // shape.cin)
    init_weights(block, make_generator(seed), random_bn=True)
    block = block.to("cuda", memory_format=torch.channels_last).eval()
    return block, fold_inverted_residual(block)


def mbconv_check(block, folded, x, got) -> tuple:
    """(kernel vs plain, kernel vs eager block) max abs errors of the
    kernel's ``got`` on NHWC x; raises past MBCONV_ATOL + MBCONV_RTOL * |ref|."""
    want = mbconv_plain(x, **folded)
    with torch.inference_mode():
        # a torch Conv2d gives (H + 1) // 2 rows at stride 2 and odd H, the
        # reference H // 2: the first H // 2 agree
        eager = block(nchw(x)).permute(0, 2, 3, 1)[:, :got.shape[1], :got.shape[2]]
    torch.cuda.synchronize()
    errs = []
    for ref, what in ((want, "plain version"), (eager, "eager block")):
        err = (got - ref).abs()
        if got.shape != ref.shape or bool((err > MBCONV_ATOL + MBCONV_RTOL * ref.abs()).any()):
            raise AssertionError(f"fused_inverted_residual {tuple(x.shape)} off the {what} "
                                 f"by {float(err.max())}")
        errs.append(float(err.max()))
    return tuple(errs)


def mbconv_row():
    """fused_inverted_residual at the encoder's 17 block shapes (timed) and
    at the ragged ones (checked only): against the plain version and the
    eager block, against float64 beside the plain version, repeat calls
    bit-equal; per block the two bounds (the 3xTF32 route and exact fp32
    on the CUDA cores) and the hidden-channel split."""
    from tpuseg_torch.ops.mbconv import mbconv_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_block, tot = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                              bound_fp32_ms=0.0, n_bytes=0.0, flops=0.0)
    max_err = max_err_eager = 0.0
    for i, shape in enumerate(MBCONV_BLOCKS + MBCONV_RAGGED):
        cin, hidden, cout, stride, use_res, expand, h, w = shape
        block, folded = mbconv_block(shape, 700 + i)
        x = randn((BATCH, h, w, cin), 720 + i)
        got = fused_inverted_residual(x, **folded)
        again = fused_inverted_residual(x, **folded)
        err, err_eager = mbconv_check(block, folded, x, got)
        if not torch.equal(got, again):
            raise AssertionError(f"fused_inverted_residual block {i + 1}: repeated calls differ")
        ref64 = mbconv_f64(x, **folded)
        err64 = float((got.double() - ref64).abs().max())
        plain_err64 = float((mbconv_plain(x, **folded).double() - ref64).abs().max())
        max_err, max_err_eager = max(max_err, err), max(max_err_eager, err_eager)
        errs = dict(max_abs_err=err, max_abs_err_vs_eager=err_eager, max_abs_err_vs_f64=err64,
                    plain_max_abs_err_vs_f64=plain_err64, repeat_bit_equal=True,
                    splits=mbconv_plan(BATCH, h, w, cin, hidden, cout, stride, sms, expand))
        if i >= len(MBCONV_BLOCKS):
            per_block.append(dict(shape=[BATCH, h, w, cin, hidden, cout, stride], ragged=True,
                                  **errs))
            continue
        ho, wo = h // stride, w // stride
        weights = sum(v.numel() for v in folded.values() if isinstance(v, torch.Tensor))
        n_bytes = 4 * (BATCH * h * w * cin + BATCH * ho * wo * cout + weights)
        flops_1x1 = 2 * BATCH * ((h * w * cin * hidden if expand else 0)
                                 + ho * wo * hidden * cout)
        flops_dw = 2 * BATCH * ho * wo * hidden * 9
        flops = flops_1x1 + flops_dw
        ins = copies(lambda j: (randn((BATCH, h, w, cin), 740 + 40 * i + j),),
                     4 * BATCH * h * w * cin)

        def eager(x, block=block):
            with torch.inference_mode():
                return block(nchw(x))

        row = dict(block=i + 1, shape=[BATCH, h, w, cin, hidden, cout, stride], **errs,
                   ms=device_ms(lambda x: fused_inverted_residual(x, **folded), ins),
                   plain_ms=device_ms(lambda x: mbconv_plain(x, **folded), ins),
                   library_ms=device_ms(eager, ins), mb=n_bytes / 1e6, gflop=flops / 1e9)
        # the route: 3 TF32 products per 1x1 term, the depthwise on the CUDA
        # cores, or the bytes, whichever is longer
        t_ops = 3 * flops_1x1 / PEAK_TF32_PER_S + flops_dw / PEAK_FP32_PER_S
        t_bytes = n_bytes / PEAK_BYTES_PER_S
        row["bound_ms"] = max(t_ops, t_bytes) * 1e3
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        row["bound_fp32_ms"], _ = bound_ms(n_bytes, flops)
        per_block.append(row)
        for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_fp32_ms"):
            tot[k] += row[k]
        tot["n_bytes"] += n_bytes
        tot["flops"] += flops
    timed_rows = [r for r in per_block if "block" in r]
    return dict(
        max_abs_err=max_err, max_abs_err_vs_eager=max_err_eager, ms=tot["ms"],
        plain_ms=tot["plain_ms"], library_ms=tot["library_ms"], bound_ms=tot["bound_ms"],
        bound_by=("operations" if all(r["bound_by"] == "operations" for r in timed_rows)
                  else "bytes"),
        bound_tc_ms=tot["bound_ms"], bound_tc_route=MBCONV_ROUTE,
        bound_fp32_ms=tot["bound_fp32_ms"],
        bound_fp32_route="exact fp32 FMA on the CUDA cores at 67 TFLOP/s",
        blocks_closer_to_f64_than_plain=sum(
            r["max_abs_err_vs_f64"] <= r["plain_max_abs_err_vs_f64"] for r in per_block),
        total_mb=tot["n_bytes"] / 1e6, total_gflop=tot["flops"] / 1e9,
        library="the port's eager InvertedResidual in eval: three cuDNN convs + BN "
                "(TF32 off); no one PyTorch call computes the block",
        per_call=per_block, note="ms are sums over the 17 encoder blocks of one forward")


def seeded_weights(cfg, path: Path) -> None:
    """Seeded full-width weights with non-trivial BatchNorm statistics."""
    model = build_model(cfg.model)
    init_weights(model, make_generator(SEED), random_bn=True)
    torch.save(model.state_dict(), path)


def serve_frames():
    rng = np.random.RandomState(SEED)
    return [rng.randint(0, 256, (BATCH, *FRAME_HW, 3), np.uint8)
            for _ in range(SERVE_BATCHES)]


def timed(p, frames):
    """(frames/s, p50 batch ms) over TIMED_BATCHES calls, host clock."""
    for f in frames[:2]:
        p(f)
    lat = []
    for i in range(TIMED_BATCHES):
        t0 = time.perf_counter()
        p(frames[i % len(frames)])
        lat.append(time.perf_counter() - t0)
    return BATCH * len(lat) / sum(lat), float(np.median(lat)) * 1e3


def check_served(outs, frames, ref, what: str):
    """(agreement per batch with ``ref``, classes seen); raises if a shape
    is off or a colour is not the palette entry of its class. An output is
    (classes, colours), or the classes alone where colorize is off."""
    palette = kernels._pack_palette(COLOR_MAP_BGR)
    agree, distinct = [], set()
    for f, out in zip(frames, outs):
        classes, colors = out if isinstance(out, tuple) else (out, None)
        if classes.shape != (BATCH, *FRAME_HW) or (
                colors is not None and colors.shape != classes.shape):
            raise AssertionError(f"{what}: output shape {classes.shape}")
        if colors is not None and not np.array_equal(colors, palette[classes]):
            raise AssertionError(f"{what}: colours are not the palette of the classes")
        agree.append(float((classes == ref(f)).mean()))
        distinct |= set(np.unique(classes).tolist())
    return agree, distinct


def model_input(pred, frames: np.ndarray) -> torch.Tensor:
    """The Predictor's preprocessed NCHW model input for one batch."""
    x = torch.from_numpy(frames).cuda().float()
    return normalize_images(resize_bilinear(x, *MODEL_HW), pred.normalize_mean,
                            pred.normalize_std).permute(0, 3, 1, 2)


def stages(p, frames):
    """Median ms of each step of Predictor.__call__, synchronized apart: the
    upload, the device stage, the fetch, and the host nearest upscale."""
    out_hw = p.input_hw if p.upscale_on_host else FRAME_HW
    ms = {"upload": [], "device": [], "fetch": [], "host_upscale": []}
    for i in range(TIMED_BATCHES):
        f = frames[i % len(frames)]
        t0 = time.perf_counter()
        x = torch.from_numpy(f).to(p.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cls, packed = p._device_forward(x, out_hw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host = [t.cpu().numpy() for t in (cls, packed) if t is not None]
        t3 = time.perf_counter()
        if p.upscale_on_host:
            for a in host:
                resize_nearest_host(a, *FRAME_HW)
        t4 = time.perf_counter()
        for k, dt in zip(ms, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            ms[k].append(dt * 1e3)
    return {k: float(np.median(v)) for k, v in ms.items()}


def phase_serve(pth: Path, name: str):
    cfg = load_config(["--model.use_pallas=true", "--model.up_subpixel=false"])
    plain_cfg = load_config(["--model.use_pallas=false", "--model.up_subpixel=false"])
    pred = Predictor(cfg.model, checkpoint=str(pth), input_hw=MODEL_HW, batch_size=BATCH)
    ref = Predictor(plain_cfg.model, checkpoint=str(pth), input_hw=MODEL_HW,
                    batch_size=BATCH)
    frames = serve_frames()

    kernels.reset_launches()
    outs = [pred(f) for f in frames]
    counts = dict(kernels.launches)
    want = {"fused_upsample_concat_conv": 4 * SERVE_BATCHES,
            "argmax_colorize": SERVE_BATCHES, "upsample2x_argmax": 0,
            "lovasz_histograms": 0, "lovasz_lookup": 0, "fused_inverted_residual": 0}
    if counts != want:
        raise AssertionError(f"serve launches {counts}, expected {want}")

    agree, distinct = check_served(outs, frames, ref, "serve")
    if min(agree) < 0.999 or len(distinct) < 2:
        raise AssertionError(f"serve agreement {agree}, classes {sorted(distinct)}")

    plain_colorize = Predictor(plain_cfg.model, checkpoint=str(pth), input_hw=MODEL_HW,
                               batch_size=BATCH, colorize_on_device=True)
    rows = {}
    for label, p in (("kernels", pred), ("plain_decoder_colorize", plain_colorize),
                     ("plain_decoder_no_colorize", ref)):
        fps, p50 = timed(p, frames)
        rows[label] = {"frames_per_s": fps, "p50_batch_ms": p50, "stages_ms": stages(p, frames)}
    emit({"phase": "serve", "card": name, "launches": counts, "agreement_min": min(agree),
          "classes_seen": sorted(distinct), "batch": BATCH, "frame_hw": list(FRAME_HW),
          "model_hw": list(MODEL_HW), **rows})
    return pred, frames, counts


@torch.inference_mode()
def phase_head(pred, frames):
    model = pred.model
    x = model_input(pred, frames[0])
    kernels.reset_launches()
    model.upsample_head = False
    half = model(x).permute(0, 2, 3, 1).contiguous()
    got = kernels.upsample2x_argmax(half)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    model.upsample_head = True
    want = {"fused_upsample_concat_conv": 4, "argmax_colorize": 0, "upsample2x_argmax": 1,
            "lovasz_histograms": 0, "lovasz_lookup": 0, "fused_inverted_residual": 0}
    if counts != want:
        raise AssertionError(f"head launches {counts}, expected {want}")
    full = model(x).permute(0, 2, 3, 1)
    if tuple(full.shape) != (BATCH, *MODEL_HW, CLASSES) or not bool(full.isfinite().all()):
        raise AssertionError("full-model logits are not finite or of the wrong shape")
    differ = got != full.argmax(dim=-1).to(torch.uint8)
    near = top2_margin(full) < NEAR_TIE
    if bool((differ & ~near).any()):
        raise AssertionError("fused head disagrees with argmax(full logits) beyond near-ties")
    emit({"phase": "head", "launches": counts, "mismatches": int(differ.sum()),
          "near_ties": int(near.sum()), "distinct_classes": int(got.unique().numel())})
    return counts


@torch.inference_mode()
def phase_mbconv(pred, frames):
    """fused_inverted_residual on the served flagship's 17 encoder blocks:
    each block's input captured by a forward pre-hook while the Predictor
    serves ``frames``, its eval BatchNorm folded; the kernel against the
    plain version and the eager block on that input."""
    blocks = list(pred.model.backbone.features)[1:18]
    captured = []
    hooks = [b.register_forward_pre_hook(
        lambda m, args, i=i: captured.append((i, nhwc(args[0]).clone())))
        for i, b in enumerate(blocks)]
    try:
        # hooks run where Python runs the forward: eager, not in a replay
        with graphs.eager():
            for f in frames:
                pred(f)
    finally:
        for hk in hooks:
            hk.remove()
    if len(captured) != 17 * len(frames):
        raise AssertionError(f"captured {len(captured)} block inputs, want {17 * len(frames)}")
    folded = [fold_inverted_residual(b) for b in blocks]
    kernels.reset_launches()
    outs = [fused_inverted_residual(x, **folded[i]) for i, x in captured]
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    want = {k: 0 for k in counts}
    want["fused_inverted_residual"] = 17 * len(frames)
    if counts != want:
        raise AssertionError(f"mbconv launches {counts}, expected {want}")
    errs = [mbconv_check(blocks[i], folded[i], x, got) for (i, x), got in zip(captured, outs)]
    emit({"phase": "mbconv", "launches": counts, "batches": len(frames),
          "max_abs_err": max(e for e, _ in errs), "max_abs_err_vs_eager": max(e for _, e in errs),
          "max_abs_err_per_block": [max(errs[k][0] for k in range(i, len(errs), 17))
                                    for i in range(17)],
          "max_abs_output": float(max(o.abs().max() for o in outs))})
    return counts


def phase_families(tmp: Path, frames):
    """The four other families at full width (registry defaults, 10
    classes) served with colorize on, each against a Predictor with
    colorize off on the same seeded weights."""
    rows = {}
    for name in FAMILIES:
        cfg = load_config([f"--model.name={name}"])
        pth = tmp / f"{name}.pth"
        seeded_weights(cfg, pth)
        kw = dict(checkpoint=str(pth), input_hw=MODEL_HW, batch_size=BATCH)
        pred = Predictor(cfg.model, colorize_on_device=True, **kw)
        ref = Predictor(cfg.model, **kw)
        kernels.reset_launches()
        outs = [pred(f) for f in frames]
        counts = dict(kernels.launches)
        want = {k: 0 for k in counts}
        want["argmax_colorize"] = len(frames)
        if counts != want:
            raise AssertionError(f"{name} launches {counts}, expected {want}")
        agree, distinct = check_served(outs, frames, ref, name)
        with torch.inference_mode():
            logits = pred.model(model_input(pred, frames[0]))
        channels = 1 if name == "light_unet" else CLASSES
        if tuple(logits.shape) != (BATCH, channels, *MODEL_HW) or \
                not bool(logits.isfinite().all()):
            raise AssertionError(f"{name} logits {tuple(logits.shape)} not finite or wrong shape")
        if min(agree) < 0.999 or (channels > 1 and len(distinct) < 2):
            raise AssertionError(f"{name} agreement {agree}, classes {sorted(distinct)}")
        fps, p50 = timed(pred, frames)
        rows[name] = {"launches": counts, "agreement_min": min(agree),
                      "classes_seen": sorted(distinct), "frames_per_s": fps,
                      "p50_batch_ms": p50,
                      "params_m": sum(p.numel() for p in pred.model.parameters()) / 1e6}
        del pred, ref
        torch.cuda.empty_cache()
    emit({"phase": "families", "batch": BATCH, "frame_hw": list(FRAME_HW),
          "model_hw": list(MODEL_HW), **rows})
    return rows


def phase_stem_s2d(pth: Path, frames):
    """The flagship served with --model.stem_s2d on the same weights as
    without: the flag is taken and serves the same class maps (the serve
    phase's kernel path)."""
    flags = ["--model.use_pallas=true", "--model.up_subpixel=false"]
    kw = dict(checkpoint=str(pth), input_hw=MODEL_HW, batch_size=BATCH)
    s2d = Predictor(load_config(flags + ["--model.stem_s2d=true"]).model, **kw)
    plain = Predictor(load_config(flags).model, **kw)
    kernels.reset_launches()
    outs = [s2d(f) for f in frames]
    counts = dict(kernels.launches)
    want = {k: 0 for k in counts}
    want.update(fused_upsample_concat_conv=4 * len(frames), argmax_colorize=len(frames))
    if counts != want:
        raise AssertionError(f"stem_s2d launches {counts}, expected {want}")
    agree, _ = check_served(outs, frames, lambda f: plain(f)[0], "stem_s2d")
    with torch.inference_mode():
        x = model_input(s2d, frames[0])
        a, b = s2d.model(x), plain.model(x)
    diff = (a - b).abs()
    if bool((diff > S2D_ATOL + S2D_RTOL * b.abs()).any()) or min(agree) < 0.999:
        raise AssertionError(f"stem_s2d: logits off by {float(diff.max())}, agreement {agree}")
    emit({"phase": "stem_s2d", "launches": counts, "agreement_min": min(agree),
          "max_abs_logit_diff": float(diff.max()), "max_abs_logit": float(b.abs().max())})


KERNEL_FLAGS = ["--model.use_pallas=true", "--model.up_subpixel=false"]
PLAIN_FLAGS = ["--model.use_pallas=false", "--model.up_subpixel=false"]


def flagship(pth: Path, flags, **kw) -> Predictor:
    return Predictor(load_config(flags).model, checkpoint=str(pth), input_hw=MODEL_HW,
                     batch_size=BATCH, **kw)


def device_margin(p: Predictor, frames: np.ndarray, host_resized: bool = False) -> np.ndarray:
    """The top-two logit margin of ``p``'s model on the input it builds for
    ``frames`` (device or host resize), nearest-upscaled to the frame size."""
    x = p._maybe_host_resize(frames) if host_resized else frames
    x = torch.from_numpy(np.ascontiguousarray(x)).cuda().float()
    if tuple(x.shape[1:3]) != MODEL_HW:
        x = resize_bilinear(x, *MODEL_HW)
    x = normalize_images(x, p.normalize_mean, p.normalize_std).permute(0, 3, 1, 2)
    with torch.inference_mode():
        margin = top2_margin(p.model(x).permute(0, 2, 3, 1)).cpu().numpy()
    return resize_nearest_host(margin, frames.shape[1], frames.shape[2])


def phase_serve_options(pth: Path, frames):
    """The Predictor's serving options on the flagship, each against the
    route it must equal."""
    from tpuseg_torch.infer.postprocess import ROAD_CLASS
    from tpuseg_torch.infer.predictor import host_resize_linear
    from tpuseg_torch.infer.video import _PinnedFetch
    from tpuseg_torch.ops import native_post

    out = {"phase": "serve_options"}
    plain = flagship(pth, PLAIN_FLAGS)
    want = [plain(f) for f in frames]

    pack4 = flagship(pth, PLAIN_FLAGS, fetch_pack4=True)
    if tuple(pack4.predict_async(frames[0]).shape) != (BATCH, MODEL_HW[0], MODEL_HW[1] // 2):
        raise AssertionError("fetch_pack4 did not fetch nibble pairs")
    if not all(np.array_equal(pack4(f), w) for f, w in zip(frames, want)):
        raise AssertionError("fetch_pack4 class maps differ from the default route")
    out["fetch_pack4"] = {"bit_equal": True}

    device_up = flagship(pth, PLAIN_FLAGS, upscale_on_host=False)
    close = flagship(pth, PLAIN_FLAGS, upscale_on_host=False, device_close=True)
    road_px = closed_px = 0
    for f in frames:
        got, ref = close(f), device_up(f)
        if not np.array_equal(got & 0x7F, ref):
            raise AssertionError("device_close: classes & 0x7F differ from the device route")
        road = ((ref == ROAD_CLASS).astype(np.uint8) * 255)
        host_close = np.stack([native_post.morph_close(r, 5) == 255 for r in road])
        if not np.array_equal(got >= 0x80, host_close):
            raise AssertionError("device_close: the 0x80 plane differs from the host close")
        road_px += int((ref == ROAD_CLASS).sum())
        closed_px += int(host_close.sum())
    out["device_close"] = {"bit_equal": True, "road_pixels": road_px, "closed_pixels": closed_px}

    pre = flagship(pth, PLAIN_FLAGS, preprocess_on_host=True)
    agree, agree_confident = [], []
    for f, w in zip(frames, want):
        got = pre(f)
        # the route is the default one fed the host-resized frames
        ref = resize_nearest_host(plain(host_resize_linear(f, *MODEL_HW)), *FRAME_HW)
        if not np.array_equal(got, ref):
            raise AssertionError("preprocess_on_host differs from the model-size-frame route")
        confident = device_margin(plain, f) > 1e-3
        agree.append(float((got == w).mean()))
        agree_confident.append(float((got == w)[confident].mean()))
    out["preprocess_on_host"] = {
        "route": pre.preprocess_route, "bit_equal_to_host_resized_default_route": True,
        "agreement_with_device_resize": agree,
        "agreement_with_device_resize_where_margin_gt_1e-3": agree_confident}

    try:
        flagship(pth, KERNEL_FLAGS, fetch_pack4=True)
    except ValueError as e:
        out["use_pallas_fetch_pack4"] = f"raises: {e}"
    else:
        raise AssertionError("use_pallas with fetch_pack4 did not raise (ROADMAP C1)")

    kern = flagship(pth, KERNEL_FLAGS)
    fetch = _PinnedFetch(2)
    for f in frames:
        outs = kern.predict_async(f)
        if not all(t.is_cuda for t in outs):
            raise AssertionError("predict_async left the device")
        cls, col = kern.finish_host(*_PinnedFetch.wait(fetch.start(outs)), *FRAME_HW)
        ref_cls, ref_col = kern(f)
        if not (np.array_equal(cls, ref_cls) and np.array_equal(col, ref_col)):
            raise AssertionError("predict_async + pinned fetch differs from __call__")
    out["predict_async_pinned_fetch"] = {"bit_equal": True}
    emit(out)


def serve_ab_routes(pth: Path) -> dict:
    """The flagship's six serving routes: the plain decoder with colorize
    off and on, and the kernel route, each with the nearest upscale on the
    host and on the device."""
    routes = {}
    for dec, flags in (("plain", PLAIN_FLAGS), ("kernels", KERNEL_FLAGS)):
        for colorize in ((False, True) if dec == "plain" else (True,)):
            for host in (True, False):
                label = (f"{dec}_decoder_colorize_{'on' if colorize else 'off'}_"
                         f"upscale_{'host' if host else 'device'}")
                routes[label] = flagship(pth, flags, colorize_on_device=colorize,
                                         upscale_on_host=host)
    return routes


def phase_serve_ab(pth: Path, frames):
    """Frames/s and p50 of the served flagship by route: the plain decoder
    with colorize off and on, and the kernel route (use_pallas, colorize
    forced on), each with the nearest upscale on the host and on the
    device; two rounds in turns (forward order, then reverse)."""
    routes = serve_ab_routes(pth)
    rows = {k: [] for k in routes}
    for order in (list(routes), list(routes)[::-1]):
        for label in order:
            fps, p50 = timed(routes[label], frames)
            rows[label].append({"frames_per_s": fps, "p50_batch_ms": p50,
                                "stages_ms": stages(routes[label], frames)})
    mean_fps = {k: float(np.mean([r["frames_per_s"] for r in v])) for k, v in rows.items()}
    emit({"phase": "serve_ab", "batch": BATCH, "frame_hw": list(FRAME_HW),
          "batches": TIMED_BATCHES, "routes": rows, "mean_frames_per_s": mean_fps,
          "fastest": max(mean_fps, key=mean_fps.get)})


class FrameCapture:
    """An in-memory capture with cv2.VideoCapture's read() and get()."""

    def __init__(self, frames: np.ndarray):
        self.frames, self.i = frames, 0

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1]

    def get(self, prop):
        return {3: float(FRAME_HW[1]), 4: float(FRAME_HW[0]), 5: 30.0}[prop]


def phase_video(pth: Path) -> dict:
    """VideoPipeline on VIDEO_FRAMES seeded BGR frames through the kernel
    route at depth 1 and 3: stats, launches, and every frame's class map
    against Predictor.__call__ on the same batch."""
    from tpuseg_torch.infer import postprocess, video
    from tpuseg_torch.ops import native_post

    frames = np.random.RandomState(SEED + 1).randint(0, 256, (VIDEO_FRAMES, *FRAME_HW, 3),
                                                     np.uint8)
    pred = flagship(pth, KERNEL_FLAGS)
    car_boxes = postprocess.cv2_or_none() is not None
    direct = np.concatenate([pred(np.ascontiguousarray(frames[i:i + BATCH, ..., ::-1]))[0]
                             for i in range(0, VIDEO_FRAMES, BATCH)])
    real = video.overlay_predictions
    seen = []

    def spy(frame, classes, **kw):
        seen.append(np.array(classes))
        return real(frame, classes, **kw)

    out = {"phase": "video", "frames_in": VIDEO_FRAMES, "batch": BATCH,
           "frame_hw": list(FRAME_HW), "car_boxes": car_boxes,
           "cv2": postprocess.cv2_or_none() is not None,
           "road_cleanup_route": "cv2" if car_boxes else "native library",
           "native_library": native_post.library_path(), "depths": {}}
    launches = {}
    video.overlay_predictions = spy
    try:
        for depth in (1, 3):
            del seen[:]
            pipe = video.VideoPipeline(pred, road_cleanup=True, car_boxes=car_boxes,
                                       pipeline_depth=depth)
            kernels.reset_launches()
            stats = pipe._run_capture(FrameCapture(frames))
            torch.cuda.synchronize()
            counts = dict(kernels.launches)
            n_fwd = VIDEO_FRAMES // BATCH + 1           # + the warm-up batch
            want = {k: 0 for k in counts}
            want.update(argmax_colorize=n_fwd, fused_upsample_concat_conv=4 * n_fwd)
            if counts != want:
                raise AssertionError(f"video launches {counts}, expected {want}")
            if stats["frames"] != VIDEO_FRAMES or len(seen) != VIDEO_FRAMES:
                raise AssertionError(f"video: {stats['frames']} frames, {len(seen)} maps")
            if not np.array_equal(np.stack(seen), direct):
                raise AssertionError(f"video depth {depth}: class maps differ from __call__")
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            out["depths"][str(depth)] = {"stats": stats, "launches": counts,
                                         "maps_bit_equal_to_call": True}
    finally:
        video.overlay_predictions = real
    out["classes_seen"] = sorted(np.unique(direct).tolist())
    emit(out)
    return launches


def http_clients(base: str, frames, n: int, clients: int):
    """``n`` raw-codec /predict requests from ``clients`` threads on
    keep-alive connections; (latencies in s, masks by request, wall s)."""
    import http.client
    import threading
    from urllib.parse import urlparse

    url = urlparse(base)
    lat, masks, errors = [None] * n, [None] * n, []
    h, w = FRAME_HW

    def client(k):
        conn = http.client.HTTPConnection(url.hostname, url.port, timeout=120)
        try:
            for i in range(k, n, clients):
                body = frames[i % len(frames)].tobytes()
                t0 = time.perf_counter()
                conn.request("POST", "/predict?format=raw", body,
                             {"Content-Type": "application/octet-stream",
                              "X-Shape": f"{h},{w},3"})
                r = conn.getresponse()
                data = r.read()
                lat[i] = time.perf_counter() - t0
                if r.status != 200:
                    raise RuntimeError(f"HTTP {r.status}: {data[:200]!r}")
                masks[i] = np.frombuffer(data, np.uint8).reshape(h, w)
        except Exception as e:  # re-raised by the caller
            errors.append(e)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return lat, masks, wall


def phase_http(pth: Path, frames) -> None:
    """The port's HTTP server in-process on 127.0.0.1:0, raw codec, the
    flagship as the server builds it, at --max_batch 1 and 8: 200 requests
    of 360x640 BGR frames from 8 client threads, every response against
    the direct Predictor on the same frame."""
    import threading
    import urllib.request

    from tpuseg_torch.tools import serve

    bgr = [f[..., ::-1].copy() for f in np.concatenate(frames)]
    out = {"phase": "http", "requests": HTTP_REQUESTS, "clients": HTTP_CLIENTS,
           "frame_hw": list(FRAME_HW), "codec": "raw", "servers": {}}
    for max_batch in (1, 8):
        args = serve.parse_args(["--port", "0", "--checkpoint", str(pth),
                                 "--max_batch", str(max_batch)])
        httpd, state = serve.make_server(args)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://%s:%d" % httpd.server_address[:2]
            kernels.reset_launches()
            lat, masks, wall = http_clients(base, bgr, HTTP_REQUESTS, HTTP_CLIENTS)
            counts = dict(kernels.launches)
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
            state.batcher.close()
        if health["requests"] != HTTP_REQUESTS:
            raise AssertionError(f"healthz counts {health['requests']} requests")
        if (max_batch > 1) != ("batching" in health) or \
                (max_batch > 1 and health["batching"]["max_batch"] != max_batch):
            raise AssertionError(f"healthz does not report the batcher: {health}")
        direct = [state.predictor(np.ascontiguousarray(f[..., ::-1])[None])[0] for f in bgr]
        differ, near = 0, 0
        for i, m in enumerate(masks):
            d = m != direct[i % len(bgr)]
            if d.any():
                # another batch size may take other cuDNN algorithms: only
                # a near-tie of the direct route's logits may flip
                f = np.ascontiguousarray(bgr[i % len(bgr)][..., ::-1])[None]
                tie = device_margin(state.predictor, f, host_resized=True)[0] < NEAR_TIE
                if bool((d & ~tie).any()):
                    raise AssertionError(f"http max_batch {max_batch}: request {i} differs "
                                         "from the direct Predictor beyond near-ties")
                differ += int(d.sum())
                near += 1
        lat_ms = np.array(lat) * 1e3
        out["servers"][str(max_batch)] = {
            "host_resize_route": state.predictor.preprocess_route,
            "requests_per_s": HTTP_REQUESTS / wall, "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)), "p90_ms": float(np.percentile(lat_ms, 90)),
            "max_ms": float(lat_ms.max()),
            "slowest_ms_by_request": {int(i): float(lat_ms[i]) for i in np.argsort(lat_ms)[-5:]},
            "wall_s": wall, "healthz": health,
            "launches": counts, "responses_bit_equal": differ == 0,
            "near_tie_pixels_differing": differ, "requests_with_near_tie_flips": near}
    emit(out)


def phase_train(perf) -> dict:
    """The slice's training configuration through tpuseg_torch.main."""
    import copy

    from tpuseg_torch.main import main as train_main
    from tpuseg_torch.ops.lovasz import lovasz_binned_plain
    from tpuseg_torch.train.loss import lovasz_errors, make_loss_fn
    from tpuseg_torch.train.optim import Optimizer
    from tpuseg_torch.train.train_step import make_train_step
    from tpuseg_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as ck:
        argv = ["--train.loss=lovasz", "--train.epochs=1",
                f"--train.steps_per_epoch={TRAIN_STEPS}", f"--data.val_split={VAL_SPLIT}",
                f"--train.checkpoint_dir={ck}", "--train.log_every=0"]
        kernels.reset_launches()
        t0 = time.perf_counter()
        tr = train_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)

        cfg, losses, rec = tr.cfg, tr.step_losses, tr.history[-1]
        want = {"argmax_colorize": 0, "upsample2x_argmax": 0, "fused_upsample_concat_conv": 0,
                "lovasz_histograms": TRAIN_STEPS, "lovasz_lookup": TRAIN_STEPS,
                "fused_inverted_residual": 0}
        if counts != want or tr.step != TRAIN_STEPS:
            raise AssertionError(f"train launches {counts} after {tr.step} steps, want {want}")
        slice_cfg = dict(name="mobilenetv2_unet", width_mult=1.0, num_classes=10,
                         up_subpixel=True, compute_dtype="float32", batch=8, hw=(128, 256),
                         lr=1.5e-4, optimizer="adam", loss="lovasz", bins=256, augment=True,
                         sources=("synthetic",))
        got_cfg = dict(name=cfg.model.name, width_mult=cfg.model.width_mult,
                       num_classes=cfg.model.num_classes, up_subpixel=cfg.model.up_subpixel,
                       compute_dtype=cfg.model.compute_dtype, batch=cfg.train.batch_size,
                       hw=(cfg.data.height, cfg.data.width), lr=cfg.train.lr,
                       optimizer=cfg.train.optimizer, loss=cfg.train.loss,
                       bins=cfg.train.lovasz_bins, augment=cfg.data.augment,
                       sources=tuple(src.kind for src in cfg.data.sources))
        if got_cfg != slice_cfg:
            raise AssertionError(f"the train phase ran {got_cfg}, not the slice's {slice_cfg}")
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train losses {losses}")
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        if not last < first:
            raise AssertionError(f"loss did not fall: first 5 {first}, last 5 {last}")
        if not math.isfinite(rec.get("val_miou", float("nan"))):
            raise AssertionError(f"no val mIoU in {rec}")
        with open(Path(ck) / "history.jsonl") as f:
            if len(f.readlines()) != 1:
                raise AssertionError("history.jsonl has not one epoch line")

        resumed = Trainer(cfg)
        if not resumed.maybe_resume() or resumed.step != tr.step or resumed.epoch != 1:
            raise AssertionError(f"resume gave step {resumed.step}, want {tr.step}")
        sd, rsd = tr.model.state_dict(), resumed.model.state_dict()
        if any(not torch.equal(sd[k], rsd[k]) for k in sd) or \
                resumed.pipeline.state() != tr.pipeline.state():
            raise AssertionError("the resumed weights or sampler differ from the saved run")
        saved = sorted(p.name for p in Path(ck).glob("step_*.pt"))
        del resumed

    # steady steps: batch wait + fused augment/step, synchronized, host clock
    lat = []
    gen = tr.pipeline.train_batches(TIMED_STEPS)
    while True:
        t0 = time.perf_counter()
        batch = next(gen, None)
        if batch is None:
            break
        tr.train_step(*batch)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    steady = lat[3:]

    # the step's stages, synchronized apart
    step = make_train_step(tr.model, tr.optimizer, loss_fn=tr._build_loss())
    st = {"host_batch": [], "upload": [], "augment": [], "fwd_loss_bwd_adam": []}
    pipe = tr.pipeline
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        host = pipe._assemble(pipe.sampler.sample(cfg.train.batch_size))
        t1 = time.perf_counter()
        dev = pipe._put(host)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        x, y = tr.augment(*dev, tr.aug_generator)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, dt in zip(st, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            st[k].append(dt * 1e3)
    stages = {k: float(np.median(v[3:])) for k, v in st.items()}
    p50 = float(np.median(steady)) * 1e3
    kernel_ms = perf["lovasz_histograms"]["ms"] + perf["lovasz_lookup"]["ms"]

    # A/B: AB_STEPS steps from one state on the same batches, with the
    # kernel loss, with a loss built on the plain versions, and with that one
    # again (the noise floor of the rest of the step). Deterministic
    # algorithms make the rest of the step repeat bit for bit, and w is
    # bit-equal on both routes, so every replayed step's gradients and the
    # final parameters must be equal; only the loss values differ (error
    # sums). The step is captured: its first call runs eagerly and then
    # captures, which leaves each p.grad a graph tensor that no kernel has
    # written yet, so the gradients are read after each replay (steps 2 on),
    # and each read must be finite and not all zero.
    start = copy.deepcopy(tr.model.state_dict())
    batches = [tr.augment(*pipe._put(pipe._assemble(pipe.sampler.sample(
        cfg.train.batch_size))), tr.aug_generator) for _ in range(AB_STEPS)]

    def plain_loss(logits, targets):
        return lovasz_binned_plain(*lovasz_errors(logits, targets))

    def ab_run(loss_fn):
        model = build_model(cfg.model).to("cuda", memory_format=torch.channels_last)
        model.load_state_dict(start)
        ab_step = make_train_step(model, Optimizer(model.parameters(), lr=cfg.train.lr),
                                  loss_fn=loss_fn)
        losses, grads = [], {}
        for i, (x, y) in enumerate(batches):
            losses.append(float(ab_step(x, y)["loss"]))
            if i > 0:
                grads.update({f"step{i + 1}.{k}": p.grad.clone()
                              for k, p in model.named_parameters()})
        if ab_step.replays() != AB_STEPS - 1:
            raise AssertionError(f"A/B: {ab_step.replays()} replays of {AB_STEPS} steps")
        norms = [float(torch.stack([g.norm() for k, g in grads.items()
                                    if k.startswith(f"step{i + 1}.")]).norm())
                 for i in range(1, AB_STEPS)]
        if not all(math.isfinite(n) and n > 0 for n in norms):
            raise AssertionError(f"A/B: replayed steps' gradient norms {norms}")
        return losses, grads, dict(model.named_parameters())

    def max_diff(a, b):
        return max(float((a[k] - b[k]).detach().abs().max()) for k in a)

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runs = {label: ab_run(fn) for label, fn in (
            ("kernels", make_loss_fn("lovasz")), ("plain", plain_loss),
            ("plain_again", plain_loss))}
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    nondeterministic_ops = sorted({str(w.message).split(" ")[0] for w in caught
                                   if "deterministic" in str(w.message)})
    (lk, gk, pk), (lp, gp, pp), (_, ga, pa) = runs.values()
    loss_diff = max(abs(a - b) for a, b in zip(lk, lp))
    ab = {"steps": AB_STEPS, "grad_steps_compared": list(range(2, AB_STEPS + 1)),
          "max_loss_diff": loss_diff, "max_grad_diff": max_diff(gk, gp), "max_param_diff": max_diff(pk, pp),
          "floor_grad_diff": max_diff(ga, gp), "floor_param_diff": max_diff(pa, pp),
          "nondeterministic_ops": nondeterministic_ops,
          "kernel_losses": lk, "plain_losses": lp}
    if loss_diff > LOVASZ_VALUE_ATOL or any(
            ab[k] != 0.0 for k in ("max_grad_diff", "max_param_diff",
                                   "floor_grad_diff", "floor_param_diff")):
        raise AssertionError(f"A/B: {ab}")

    out = {"phase": "train", "launches": counts, "steps": tr.step, "wall_s": wall,
           "loss_first5": first, "loss_last5": last, "losses_every10": losses[::10],
           "val_miou": rec["val_miou"], "val_pixel_acc": rec["val_pixel_acc"],
           "epoch_imgs_per_s": rec["imgs_per_sec"], "checkpoints": saved,
           "steady_imgs_per_s": cfg.train.batch_size * len(steady) / sum(steady),
           "p50_step_ms": p50,
           "stages_ms": stages,
           # an estimate: the kernels' isolated times (cold L2, CUDA graph)
           # over the host-clock p50 step, not a time measured in the step
           "lovasz_kernels_isolated_ms": kernel_ms,
           "lovasz_kernels_isolated_ms_over_p50_step": kernel_ms / p50,
           "ab": ab}
    emit(out)
    return out


def check_packed(src, ref, n: int) -> dict:
    """Every packed sample bit-equal to the source it was packed from; one
    batch gathered into pinned buffers (the native gather, which must
    have loaded) bit-equal to numpy's fancy index."""
    from tpuseg_torch.ops import native_loader

    if len(src) != n:
        raise AssertionError(f"train_packed: {len(src)} packed samples, want {n}")
    differ = [i for i in range(n)
              if not all(np.array_equal(a, b) for a, b in zip(src.load(i), ref.load(i)))]
    if differ:
        raise AssertionError(f"train_packed: packed samples {differ[:8]} differ from the source")
    lib = native_loader.library_path()
    if lib is None:
        raise AssertionError("train_packed: the native gather did not load: "
                             f"{native_loader.unavailable_reason()}")
    idx = np.random.RandomState(SEED).randint(0, n, BATCH).astype(np.int64)
    img = torch.empty((BATCH, *src.images.shape[1:]), dtype=torch.uint8, pin_memory=True)
    msk = torch.empty((BATCH, *src.masks.shape[1:]), dtype=torch.uint8, pin_memory=True)
    src.load_batch(idx, img.numpy(), msk.numpy())
    if not (img.is_pinned() and np.array_equal(img.numpy(), src.images[idx])
            and np.array_equal(msk.numpy(), src.masks[idx])):
        raise AssertionError("train_packed: the pinned native gather differs from numpy's")
    return {"samples_bit_equal": n, "native_loader": str(Path(lib).relative_to(ROOT)),
            "pinned_gather_bit_equal": True}


def cv2_refusal(directory: str) -> str:
    """A directory source with cv2 refused raises the named error."""
    from tpuseg_torch.configs import DatasetSourceConfig
    from tpuseg_torch.data.sources import build_source

    try:
        build_source(DatasetSourceConfig(kind="carla", img_dir=directory, mask_dir=directory),
                     MODEL_HW[1], MODEL_HW[0])
    except ImportError as e:
        msg = str(e)
        if 'kind="packed"' in msg and "python -m tpuseg_torch.tools.pack_dataset" in msg:
            return msg
        raise AssertionError(f"train_packed: the cv2 refusal does not name the packed route: "
                             f"{msg}") from e
    raise AssertionError("train_packed: a carla source built with cv2 refused")


def phase_train_packed(synthetic: dict, packed: str) -> dict:
    """The slice's training from a packed dataset (see the module), packed
    into the directory ``packed``, which the train_contact phase reads
    next."""
    from tpuseg_torch.data.class_stats import resolve_auto_class_weights
    from tpuseg_torch.data.sources import PackedSource, SyntheticSource
    from tpuseg_torch.main import main as train_main
    from tpuseg_torch.tools import pack_dataset

    h, w = MODEL_HW
    out = {"phase": "train_packed", "samples": PACKED_SAMPLES}
    t0 = time.perf_counter()
    if pack_dataset.main(["--kind", "synthetic", "--num_samples", str(PACKED_SAMPLES),
                          "--out", packed, "--width", str(w), "--height", str(h)]) != 0:
        raise AssertionError("train_packed: pack_dataset failed")
    out["pack_s"] = time.perf_counter() - t0
    src = PackedSource(packed, w, h)
    out["packed_mb"] = (src.images.nbytes + src.masks.nbytes) / 2**20
    out.update(check_packed(src, SyntheticSource(PACKED_SAMPLES, w, h), PACKED_SAMPLES))
    out["cv2_refusal"] = cv2_refusal(packed)

    flags = [f"--data.sources={json.dumps([{'kind': 'packed', 'packed_dir': packed, 'weight': 1.0}])}",
             *PACKED_FLAGS]
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr = train_main(flags + ["--train.epochs=1", f"--train.steps_per_epoch={TRAIN_STEPS}",
                             f"--data.val_split={VAL_SPLIT}", "--train.checkpoint_dir=",
                             "--train.log_every=0"])
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    counts = dict(kernels.launches)
    cfg, losses, rec = tr.cfg, tr.step_losses, tr.history[-1]
    want = {"argmax_colorize": 0, "upsample2x_argmax": 0, "fused_upsample_concat_conv": 0,
            "lovasz_histograms": TRAIN_STEPS, "lovasz_lookup": TRAIN_STEPS,
            "fused_inverted_residual": 0}
    if counts != want or tr.step != TRAIN_STEPS:
        raise AssertionError(f"train_packed launches {counts} after {tr.step} steps, "
                             f"want {want}")
    got_cfg = (cfg.model.name, cfg.model.width_mult, cfg.train.batch_size,
               (cfg.data.height, cfg.data.width), cfg.train.loss, cfg.data.heavy_augment,
               type(tr.combined.sources[0]).__name__)
    if got_cfg != ("mobilenetv2_unet", 1.0, BATCH, MODEL_HW, "ce+lovasz", True,
                   "PackedSource"):
        raise AssertionError(f"train_packed ran {got_cfg}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_packed losses {losses}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not last < first:
        raise AssertionError(f"train_packed: loss did not fall: first 10 {first}, "
                             f"last 10 {last}")
    if not math.isfinite(rec.get("val_miou", float("nan"))):
        raise AssertionError(f"train_packed: no val mIoU in {rec}")
    weights = resolve_auto_class_weights(tr.combined, cfg.model.num_classes, "auto")
    if tr.class_weights != weights:
        raise AssertionError(f"train_packed: the Trainer resolved {tr.class_weights}, "
                             f"resolve_auto_class_weights gives {weights}")
    out.update({"launches": counts, "steps": tr.step, "loss_first10": first,
                "loss_last10": last, "losses_every10": losses[::10],
                "val_miou": rec["val_miou"], "class_weights": list(weights),
                "epoch_imgs_per_s": rec["imgs_per_sec"]})

    # the stages, synchronized apart: the host batch (sampler, pinned
    # buffers, one gather), the upload, the heavy augment eager and
    # alone, the captured step
    pipe, bs = tr.pipeline, cfg.train.batch_size
    g = torch.Generator(device="cuda").manual_seed(SEED)
    st = {"host_batch": [], "upload": [], "heavy_augment_eager": [], "captured_step": []}
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        host = pipe._assemble(pipe.sampler.sample(bs))
        t1 = time.perf_counter()
        dev = pipe._put(host)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tr.augment(*dev, g)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        tr.train_step(*dev)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, dt in zip(st, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            st[k].append(dt * 1e3)
    # steady steps: the loader thread feeding the captured step
    lat = []
    gen = pipe.train_batches(TIMED_STEPS)
    while True:
        t0 = time.perf_counter()
        batch = next(gen, None)
        if batch is None:
            break
        tr.train_step(*batch)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    steady = lat[3:]
    del tr, gen
    packed_t = {"stages_ms": {k: float(np.median(v[3:])) for k, v in st.items()},
                "p50_step_ms": float(np.median(steady)) * 1e3,
                "steady_imgs_per_s": bs * len(steady) / sum(steady)}
    out["timing"] = {"packed": packed_t, "synthetic": {
        k: synthetic[k] for k in ("stages_ms", "p50_step_ms", "steady_imgs_per_s")}}

    # captured against eager, deterministic algorithms, from one state
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        out["captured_vs_eager"] = train_ab(flags, "packed heavy", lovasz=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    emit(out)
    return out


# the train_contact phase: the training path as a user of the JAX package
# runs it, from the packed set: a seeded torchvision encoder imported, QAT
# from it, a fast student distilled from the QAT run, eval_miou on that
# run's checkpoint, then QAT + distillation over two ranks
CONTACT_STEPS, CONTACT_MESH_STEPS, CONTACT_EVAL_SAMPLES, CONTACT_SEED = 40, 3, 64, 7
CONTACT_RUN = ["--train.epochs=1", f"--train.steps_per_epoch={CONTACT_STEPS}",
               "--data.val_split=0", "--train.log_every=0"]
KD_FLAGS = ["--train.distill_model=mobilenetv2_unet", "--train.distill_alpha=0.5",
            "--train.distill_temperature=2"]


def packed_source_flag(packed: str) -> str:
    return f"--data.sources={json.dumps([{'kind': 'packed', 'packed_dir': packed, 'weight': 1.0}])}"


def torchvision_encoder_sd(seed: int) -> dict:
    """A full-width torchvision ``mobilenet_v2`` state_dict made from a seed:
    the port's encoder has torchvision's module names and shapes
    (``features.0-18.*``, BatchNorm statistics seeded away from 0/1), and
    the ImageNet head's ``classifier.1.*`` goes beside it."""
    enc = MobileNetV2Encoder()
    init_weights(enc, make_generator(seed), random_bn=True)
    sd = {k: v.clone() for k, v in enc.state_dict().items()}
    sd["classifier.1.weight"] = torch.empty(1000, 1280).uniform_(
        -0.05, 0.05, generator=make_generator(seed + 1))
    sd["classifier.1.bias"] = torch.zeros(1000)
    return sd


def contact_import(tmp: Path) -> tuple:
    """(1) The seeded encoder through ``tpuseg_torch.tools.import_pretrained``:
    every encoder tensor equals its source, the decoder the port's seeded
    init. Returns (the checkpoint directory, the phase's record)."""
    from tpuseg_torch.infer.predictor import load_variables
    from tpuseg_torch.tools import import_pretrained

    sd = torchvision_encoder_sd(CONTACT_SEED)
    pth, out = tmp / "mobilenet_v2.pth", tmp / "pretrained"
    torch.save(sd, str(pth))
    if import_pretrained.main(["--pth", str(pth), "--out", str(out)]) != 0:
        raise AssertionError("train_contact: import_pretrained failed")
    got = load_variables(str(out), lambda: None)
    seeded = build_model(load_config([]).model).state_dict()
    enc = [k for k in got if k.startswith("backbone.")
           and not k.endswith("num_batches_tracked")]
    dec = [k for k in got if not k.startswith("backbone.")]
    want_enc = [k for k in sd if k.startswith("features.")
                and not k.endswith("num_batches_tracked")]
    row = {"source_tensors": len(sd), "encoder_tensors": len(enc), "decoder_tensors": len(dec),
           "encoder_equal": all(torch.equal(got[k], sd[k[len("backbone."):]]) for k in enc),
           "decoder_equal_seeded_init": all(torch.equal(got[k], seeded[k]) for k in dec)}
    if len(enc) != len(want_enc) or not row["encoder_equal"] or \
            not row["decoder_equal_seeded_init"]:
        raise AssertionError(f"train_contact: import {row}")
    return str(out), row


def contact_run(argv, steps: int, what: str):
    """``tpuseg_torch.main`` on ``argv``: the Trainer, its launches (both
    Lovász kernels once a step, nothing else) and the first and last 5
    losses (the loss must fall)."""
    from tpuseg_torch.main import main as train_main

    kernels.reset_launches()
    tr = train_main(argv)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    want = {k: 0 for k in counts}
    want.update(lovasz_histograms=steps, lovasz_lookup=steps)
    losses = tr.step_losses
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if counts != want or tr.step != steps or not all(math.isfinite(v) for v in losses) \
            or not last < first or not hasattr(tr.train_step, "replays"):
        raise AssertionError(f"train_contact: {what} launches {counts} after {tr.step} "
                             f"steps, losses first 5 {first}, last 5 {last}")
    return tr, {"launches": counts, "steps": tr.step, "loss_first5": first,
                "loss_last5": last, "losses_every10": losses[::10]}


def fake_quant_card_vs_cpu(tr) -> dict:
    """fake_quant_act on every QAT conv's input of a train-mode forward of
    ``tr.model`` (one augmented batch) and fake_quant_kernel on its weight,
    on the card and on the CPU: bit-equal."""
    from tpuseg_torch.ops.fake_quant import fake_quant_act, fake_quant_kernel, qat_convs

    convs = qat_convs(tr.model)
    inputs = []
    hooks = [conv.register_forward_pre_hook(lambda m, a: inputs.append(a[0].detach().clone()))
             for _, conv in convs]
    try:
        x, _ = tr.augment(*draw_batches(tr, 1)[0], torch.Generator(device="cuda").manual_seed(SEED))
        with graphs.eager(), torch.no_grad():
            tr.model.train()(x.permute(0, 3, 1, 2))
    finally:
        for h in hooks:
            h.remove()
    act = [torch.equal(fake_quant_act(a).cpu(), fake_quant_act(a.cpu())) for a in inputs]
    ker = [torch.equal(fake_quant_kernel(c.weight.detach()).cpu(),
                       fake_quant_kernel(c.weight.detach().cpu())) for _, c in convs]
    row = {"convs": len(convs), "activations_bit_equal": sum(act),
           "kernels_bit_equal": sum(ker),
           "elements": sum(a.numel() for a in inputs) + sum(c.weight.numel() for _, c in convs)}
    if len(inputs) != len(convs) or not all(act) or not all(ker):
        raise AssertionError(f"train_contact: fake-quant on the card against the CPU {row}")
    return row


def in_turns(configs: dict) -> dict:
    """``train_timing`` of each configuration ({label: flags}) in turns:
    in order, then in reverse (a, b, b, a)."""
    rows = {label: [] for label in configs}
    for label in [*configs, *reversed(configs)]:
        rows[label].append(train_timing(configs[label], 1, False))
    return rows


def deterministic_ab(flags, label: str) -> dict:
    """``train_ab`` (3 captured steps against 3 eager) under deterministic algorithms."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        return train_ab(flags, label, lovasz=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def teacher_in_step(tr) -> dict:
    """The teacher logits of a captured distilled step (its images and
    logits copied out inside the graph) against an eval forward of the
    teacher on the same images: bit-equal."""
    from tpuseg_torch.train.train_step import make_train_step

    h, w = MODEL_HW
    images = torch.empty(BATCH, h, w, 3, device="cuda")
    logits = torch.empty(BATCH, h, w, CLASSES, device="cuda")

    def tapped(x):
        out = tr.teacher_fn(x)
        images.copy_(x)
        logits.copy_(out)
        return out

    step = make_train_step(tr.model, tr.optimizer, loss_fn=tr.loss_fn, augment_fn=tr.augment,
                           generator=tr.aug_generator, teacher_fn=tapped)
    for batch in draw_batches(tr, 2):
        step(*batch)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = tr.teacher.eval()(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    row = {"replays": step.replays(), "bit_equal": bool(torch.equal(want, logits)),
           "max_abs_diff": float((want - logits).abs().max())}
    if row["replays"] != 1 or not row["bit_equal"]:
        raise AssertionError(f"train_contact: in-step teacher logits {row}")
    return row


def contact_eval(ck: str) -> dict:
    """(4) ``tpuseg_torch.tools.eval_miou`` on ``ck`` against the Trainer's
    own evaluate of it on the same set (the same confusion matrix), and
    its images/s."""
    import io

    from tpuseg_torch.tools import eval_miou
    from tpuseg_torch.train.trainer import Trainer

    n, bs = CONTACT_EVAL_SAMPLES, 32
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = eval_miou.main(["--kind", "synthetic", "--samples", str(n), "--batch", str(bs),
                             "--checkpoint", ck])
    wall = time.perf_counter() - t0
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    src = json.dumps([{"kind": "synthetic", "num_samples": n, "weight": 1.0}])
    tr = Trainer(load_config([f"--data.sources={src}", "--data.val_split=1.0",
                              f"--train.batch_size={bs}", f"--train.init_checkpoint={ck}",
                              "--train.checkpoint_dir="]))
    rec = tr.evaluate()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = tr.evaluate()
    torch.cuda.synchronize()
    second = time.perf_counter() - t0
    want_iou = [None if v is None else round(v, 4) for v in rec["val_iou_per_class"]]
    row = {"eval_miou": got, "trainer": {k: rec[k] for k in ("val_miou", "val_pixel_acc",
                                                                "val_loss")},
           "tool_wall_s": wall, "tool_images_per_s": n / wall,
           "trainer_second_pass_images_per_s": n / second}
    if rc != 0 or got["n_images"] != n or got["miou"] != rec["val_miou"] or \
            got["pixel_acc"] != rec["val_pixel_acc"] or got["iou_per_class"] != want_iou or \
            again["val_miou"] != rec["val_miou"]:
        raise AssertionError(f"train_contact: eval_miou against the Trainer {row}")
    return row


def contact_rank(device, flags, n_convs: int) -> dict:
    """One rank of the train_contact phase's mesh run: records the first
    ``n_convs`` activation scales (this rank's absmax and the scale used)."""
    import hashlib

    from tpuseg_torch.main import main as train_main
    from tpuseg_torch.ops import fake_quant

    seen = []
    act_scale = fake_quant.act_scale

    def recorded(xf, mesh=None, spatial=False):
        scale = act_scale(xf, mesh, spatial)
        if len(seen) < n_convs:
            seen.append((xf.detach().abs().amax().item(), scale.item(), mesh is not None))
        return scale

    fake_quant.act_scale = recorded
    kernels.reset_launches()
    tr = train_main(flags)
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for v in tr.model.state_dict().values():
        digest.update(v.cpu().numpy().tobytes())
    return {"rank": tr.mesh.rank, "backend": tr.mesh.backend, "scales": seen,
            "losses": tr.step_losses, "steps": tr.step, "digest": digest.hexdigest(),
            "launches": {k: v for k, v in kernels.launches.items() if v},
            "teacher": tr.teacher is not None, "captured": hasattr(tr.train_step, "replays")}


def contact_ranks(flags, n_convs: int) -> dict:
    """(5) QAT + distillation over two ranks sharing the card (gloo): each
    QAT conv's scale on both ranks equals the scale of a one-process run
    over the global batch (the max of the ranks' absmaxes: a max is exact),
    and the parameters are bit-equal across ranks."""
    from tpuseg_torch.core.mesh import launch_local
    from tpuseg_torch.ops.fake_quant import INV_LEVELS

    t0 = time.perf_counter()
    ranks = launch_local(contact_rank, MESH_RANKS, device="cuda", timeout_s=600,
                         args=(flags, n_convs))
    wall = time.perf_counter() - t0
    r0, r1 = ranks
    equal, local_differ = 0, 0
    for (l0, s0, m0), (l1, s1, m1) in zip(r0["scales"], r1["scales"]):
        one = (torch.clamp(torch.tensor(max(l0, l1), device="cuda"), min=1e-8)
               * INV_LEVELS).item()
        equal += int(s0 == s1 == one and m0 and m1)
        local_differ += int(l0 != l1)
    want = {"lovasz_histograms": CONTACT_MESH_STEPS, "lovasz_lookup": CONTACT_MESH_STEPS}
    row = {"route": mesh_route(MESH_RANKS)[0], "wall_s": wall,
           "scales_recorded": [len(r["scales"]) for r in ranks],
           "scales_equal_one_process": equal, "convs_whose_rank_absmax_differ": local_differ,
           "params_bit_equal_across_ranks": r0["digest"] == r1["digest"],
           "losses": r0["losses"], "launches_per_rank": [r["launches"] for r in ranks]}
    if (any(len(r["scales"]) != n_convs or r["launches"] != want or not r["teacher"]
            or r["captured"] or r["steps"] != CONTACT_MESH_STEPS
            or not all(math.isfinite(v) for v in r["losses"]) for r in ranks)
            or equal != n_convs or local_differ == 0
            or not row["params_bit_equal_across_ranks"] or r0["losses"] != r1["losses"]):
        raise AssertionError(f"train_contact: two ranks {row}")
    return row


def phase_train_contact(packed: str) -> dict:
    """The rest of the training path (see the module): (1) a seeded
    torchvision encoder imported, (2) QAT from it, (3) an FPN student
    distilled from the QAT run, (4) eval_miou of the QAT run, (5) QAT +
    distillation over two ranks."""
    from tpuseg_torch.ops.fake_quant import qat_convs

    src = packed_source_flag(packed)
    out = {"phase": "train_contact", "config": {
        "model": "mobilenetv2_unet", "student": "mobilenetv2_fpn", "classes": CLASSES,
        "hw": list(MODEL_HW), "batch": BATCH, "loss": "lovasz", "data": "packed",
        "tf32": False}}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        pre, out["import"] = contact_import(Path(tmp))
        ck = str(Path(tmp) / "qat")

        # (2) QAT from the imported encoder
        qat = [src, f"--train.init_checkpoint={pre}", "--train.qat=true", "--train.loss=lovasz"]
        tr, row = contact_run(qat + CONTACT_RUN + [f"--train.checkpoint_dir={ck}"],
                              CONTACT_STEPS, "qat")
        n_convs = len(qat_convs(tr.model))
        plain = {k: v.shape for k, v in build_model(tr.cfg.model).state_dict().items()}
        row.update(qat_convs=n_convs, state_dict_as_without_qat=plain == {
            k: v.shape for k, v in tr.model.state_dict().items()},
            checkpoint=sorted(p.name for p in Path(ck).glob("step_*.pt")),
            fake_quant_card_vs_cpu=fake_quant_card_vs_cpu(tr))
        del tr
        if not row["state_dict_as_without_qat"] or row["checkpoint"] != [
                f"step_{CONTACT_STEPS}.pt"] or n_convs != 61:
            raise AssertionError(f"train_contact: qat {row}")
        row["captured_vs_eager"] = deterministic_ab(qat, "qat")
        # QAT trains the materialized decoder: the plain step both with the
        # default subpixel decoder and with the materialized one
        plain_flags = [f for f in qat if f != "--train.qat=true"]
        row["timing"] = in_turns({"plain": plain_flags,
                                  "plain_materialized": plain_flags
                                  + ["--model.up_subpixel=false"], "qat": qat})
        out["qat"] = row

        # (3) a fast student distilled from the QAT run
        student = [src, "--model.name=mobilenetv2_fpn", "--train.loss=lovasz"]
        kd = student + [f"--train.distill_checkpoint={ck}", *KD_FLAGS]
        tr, row = contact_run(kd + CONTACT_RUN + ["--train.checkpoint_dir="], CONTACT_STEPS,
                              "distill")
        if tr.teacher is None or tr.teacher.training or type(tr.teacher).__name__ != \
                "MobileNetV2UNet":
            raise AssertionError("train_contact: the distilled run has no frozen teacher")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        try:
            row["teacher_in_step"] = teacher_in_step(tr)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        h, w = MODEL_HW
        ins = copies(lambda i: (torch.randn(BATCH, h, w, 3, device="cuda"),),
                     BATCH * h * w * 3 * 4)
        row["teacher_forward_ms"] = device_ms(tr.teacher_fn, ins)
        del tr, ins
        row["captured_vs_eager"] = deterministic_ab(kd, "distill")
        row["timing"] = in_turns({"student": student, "distilled": kd})
        step_ms = float(np.median([r["device_step_ms"] for r in row["timing"]["distilled"]]))
        row["teacher_share_of_device_step"] = row["teacher_forward_ms"] / step_ms
        out["distill"] = row

        # (4) eval_miou on the QAT run's checkpoint
        out["eval_miou"] = contact_eval(ck)

        # (5) QAT + distillation over two ranks
        mesh = [f"--mesh.data={MESH_RANKS}", *qat, f"--train.distill_checkpoint={ck}",
                *KD_FLAGS, "--train.epochs=1", f"--train.steps_per_epoch={CONTACT_MESH_STEPS}",
                "--data.val_split=0", "--train.checkpoint_dir=", "--train.log_every=0"]
        out["ranks"] = contact_ranks(mesh, n_convs)
    out["launches"] = {k: out["qat"]["launches"][k] + out["distill"]["launches"][k]
                       for k in out["qat"]["launches"]}
    out["mesh_launches_per_rank"] = out["ranks"]["launches_per_rank"]
    emit(out)
    return out


# the bf16 phase: ModelConfig.compute_dtype=bfloat16 on the slice's paths
BF16 = torch.bfloat16
BF16_FLAGS = ["--model.compute_dtype=bfloat16"]
BF16_TRAIN_STEPS, BF16_OPTION_STEPS = 40, 5
# Two bf16 routes round at other places, so their logits differ by some
# bf16 steps, and seeded weights leave many near-ties: at this size, on
# these weights and frames, the JAX package's own bf16 kernel and plain
# routes agree on 98.87% of the pixels, and the port's two routes on the
# CPU on 98.76% (tools/bf16_route_agreement.py). Each route's served class
# maps are held to BF16_SERVED_AGREE of the bf16 plain-path Predictor's,
# and its captured maps bit-equal to its eager ones; the logits within
# BF16_LOGIT_TOL of their largest magnitude (tests/test_torch_port_bf16.py's
# bound against the JAX package), and equal picks wherever the top-two
# margin exceeds twice the largest logit gap (where no pick can flip). The
# agreement above BF16_MARGIN is reported.
BF16_MARGIN = 1e-2
BF16_LOGIT_TOL = 2 ** -4
BF16_SERVED_AGREE = 0.98
BF16_EPS = 2.0 ** -8      # one bf16 step, relative to the value's power of two


def bf16_block_check(x16, folded, got) -> float:
    """fused_inverted_residual on bf16 ``x16``: ``got`` must be the f32
    route on the widened x rounded once (bit-equal), and lie from the plain
    version within 1e-4 before rounding or one bf16 step after. Returns
    the largest gap to the plain version."""
    f32 = fused_inverted_residual(x16.float(), **folded)
    if not torch.equal(got, f32.to(BF16)):
        raise AssertionError("bf16 block: not the f32 route rounded once")
    want = mbconv_plain(x16, **folded).float()
    gap = (got.float() - want).abs()
    if bool((gap > 2 * BF16_EPS * want.abs() + MBCONV_ATOL).any()):
        raise AssertionError(f"bf16 block off its plain version by {float(gap.max())}")
    return float(gap.max())


def bf16_kernel_rows(perf) -> dict:
    """(a) The four kernels that take activations or logits, on bf16 inputs
    at the slice's shapes: against their plain versions and the f32 route
    on the widened inputs, timed beside their fp32 rows. Bounds count the
    bf16 bytes read."""
    rows = {}
    # argmax_colorize at [8,128,256,10]
    shape = (BATCH, *MODEL_HW, CLASSES)
    logits = randn(shape, 31).to(BF16)
    cls_k, col_k = kernels.argmax_colorize(logits, COLOR_MAP_BGR)
    cls_p, col_p = kernels.argmax_colorize_plain(logits, COLOR_MAP_BGR)
    torch.cuda.synchronize()
    if not (torch.equal(cls_k, cls_p) and torch.equal(col_k.view(torch.int32),
                                                      col_p.view(torch.int32))):
        raise AssertionError("bf16 argmax_colorize disagrees with its plain version")
    n_pix = BATCH * MODEL_HW[0] * MODEL_HW[1]
    ins = copies(lambda i: (randn(shape, 130 + i).to(BF16),), n_pix * CLASSES * 2)
    words = kernels._words_for(COLOR_MAP_BGR, logits.device)
    rows["argmax_colorize"] = dict(
        max_abs_err=float(below_max(logits.float(), cls_k).max()), bit_equal=True,
        ms=device_ms(lambda x: kernels.argmax_colorize(x, COLOR_MAP_BGR), ins),
        plain_ms=device_ms(lambda x: kernels.argmax_colorize_plain(x, COLOR_MAP_BGR), ins),
        library_ms=device_ms(lambda x: words[torch.argmax(x, dim=-1)], ins))
    rows["argmax_colorize"]["bound_ms"], rows["argmax_colorize"]["bound_by"] = bound_ms(
        n_pix * CLASSES * 2 + n_pix * 5 + CLASSES * 4, n_pix * (CLASSES - 1))

    # upsample2x_argmax at [8,64,128,10]
    shape = (BATCH, MODEL_HW[0] // 2, MODEL_HW[1] // 2, CLASSES)
    logits = randn(shape, 32).to(BF16)
    got = kernels.upsample2x_argmax(logits)
    if not (torch.equal(got, kernels.upsample2x_argmax_plain(logits))
            and torch.equal(got, kernels.upsample2x_argmax(logits.float()))):
        raise AssertionError("bf16 upsample2x_argmax differs from its plain version or "
                             "from the f32 route on the widened logits")
    n_in = math.prod(shape)
    ins = copies(lambda i: (randn(shape, 230 + i).to(BF16),), n_in * 2)
    lib_ins = [(x.permute(0, 3, 1, 2).contiguous(),) for (x,) in ins]
    up = upsample2x_bilinear(logits.float(), align_corners=True)
    rows["upsample2x_argmax"] = dict(
        max_abs_err=float(below_max(up, got).max()), bit_equal=True,
        ms=device_ms(kernels.upsample2x_argmax, ins),
        plain_ms=device_ms(kernels.upsample2x_argmax_plain, ins),
        library_ms=device_ms(lambda x: F.interpolate(
            x.float(), scale_factor=2, mode="bilinear", align_corners=True).argmax(1), lib_ins),
        library="F.interpolate(widened, align_corners=True).argmax(1)")
    rows["upsample2x_argmax"]["bound_ms"], rows["upsample2x_argmax"]["bound_by"] = bound_ms(
        n_in * 2 + BATCH * MODEL_HW[0] * MODEL_HW[1], BATCH * MODEL_HW[0] * MODEL_HW[1]
        * CLASSES * 7)

    # fused_upsample_concat_conv at the four decoder shapes, bf16 skip and x
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, library_bf16_ms=0.0, bound_ms=0.0)
    max_err = 0.0
    for k, (sshape, xshape, cout) in UPCONCAT_SHAPES.items():
        cin = sshape[-1] + xshape[-1]

        def make(i, sshape=sshape, xshape=xshape, cin=cin, cout=cout):
            return (randn(sshape, 330 + 4 * i).to(BF16), randn(xshape, 331 + 4 * i).to(BF16),
                    randn((3, 3, cin, cout), 332 + 4 * i, 0.05),
                    randn((cout,), 333 + 4 * i, 0.1))

        skip, x, w, b = make(0)
        got = kernels.fused_upsample_concat_conv(skip, x, w, b)
        want = kernels.fused_upconcat_plain(skip, x, w, b)
        err = (got - want).abs()
        if got.dtype != torch.float32 or bool(
                (err > UPCONCAT_ATOL + UPCONCAT_RTOL * want.abs()).any()):
            raise AssertionError(f"bf16 fused_upsample_concat_conv {k}: max err "
                                 f"{float(err.max())}")
        if not torch.equal(got, kernels.fused_upsample_concat_conv(skip.float(), x.float(),
                                                                   w, b)):
            raise AssertionError(f"bf16 fused_upsample_concat_conv {k}: not the f32 route "
                                 "on the widened inputs")
        max_err = max(max_err, float(err.max()))
        n_bytes = (2 * (math.prod(sshape) + math.prod(xshape))
                   + 4 * (9 * cin * cout + cout + math.prod(sshape[:3]) * cout))
        flops = 2 * math.prod(sshape[:3]) * cout * 9 * cin
        ins = copies(make, n_bytes)
        lib = [(s.permute(0, 3, 1, 2), xx.permute(0, 3, 1, 2),
                ww.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), bb)
               for s, xx, ww, bb in ins]

        def cudnn(s, xx, ww, bb):         # the same function: widened, fp32 conv
            return F.conv2d(torch.cat([s.float(), F.interpolate(
                xx.float(), scale_factor=2, mode="bilinear", align_corners=False)], dim=1),
                ww, bb, padding=1)

        def cudnn_bf16(s, xx, ww, bb):    # context: rounds the upsample and the weights
            return F.conv2d(torch.cat([s, F.interpolate(
                xx, scale_factor=2, mode="bilinear", align_corners=False)], dim=1),
                ww.to(BF16), bb.to(BF16), padding=1)

        row = dict(ms=device_ms(kernels.fused_upsample_concat_conv, ins),
                   plain_ms=device_ms(kernels.fused_upconcat_plain, ins),
                   library_ms=device_ms(cudnn, lib), library_bf16_ms=device_ms(cudnn_bf16, lib))
        # a widened bf16 activation is a TF32 value: each multiply-add is 2
        # TF32 products (the activation by the weight's two parts), not 3
        row["bound_ms"], _ = bound_ms(n_bytes, 2 * flops, PEAK_TF32_PER_S)
        for key in tot:
            tot[key] += row[key]
    rows["fused_upsample_concat_conv"] = dict(
        max_abs_err=max_err, **tot, bound_by="operations",
        library="cuDNN fp32 conv2d over the widened materialized concat (channels_last, "
                "TF32 off)",
        library_bf16="cuDNN bf16 conv2d over the bf16 concat: rounds the upsample and the "
                     "weights, not the same function")

    # fused_inverted_residual at the encoder's 17 blocks, bf16 x
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    max_err = 0.0
    for i, shape in enumerate(MBCONV_BLOCKS):
        cin, hidden, cout, stride, use_res, expand, h, w = shape
        block, folded = mbconv_block(shape, 700 + i)
        x16 = randn((BATCH, h, w, cin), 760 + i).to(BF16)
        got = fused_inverted_residual(x16, **folded)
        if got.dtype != BF16:
            raise AssertionError(f"bf16 block {i + 1} wrote {got.dtype}")
        max_err = max(max_err, bf16_block_check(x16, folded, got))
        ho, wo = h // stride, w // stride
        weights = sum(v.numel() for v in folded.values() if isinstance(v, torch.Tensor))
        n_bytes = 2 * (BATCH * h * w * cin + BATCH * ho * wo * cout) + 4 * weights
        # the expand's input is the bf16 x (2 TF32 products a multiply-add),
        # the project's the fp32 hidden tensor (3)
        flops_expand = 2 * BATCH * h * w * cin * hidden if expand else 0
        flops_project = 2 * BATCH * ho * wo * hidden * cout
        flops_dw = 2 * BATCH * ho * wo * hidden * 9
        ins = copies(lambda j: (randn((BATCH, h, w, cin), 800 + 40 * i + j).to(BF16),),
                     2 * BATCH * h * w * cin)

        def eager(x, block=block):
            with torch.inference_mode():
                return block(nchw(x.float()))

        tot["ms"] += device_ms(lambda x: fused_inverted_residual(x, **folded), ins)
        tot["plain_ms"] += device_ms(lambda x: mbconv_plain(x, **folded), ins)
        tot["library_ms"] += device_ms(eager, ins)
        tot["bound_ms"] += max((2 * flops_expand + 3 * flops_project) / PEAK_TF32_PER_S
                               + flops_dw / PEAK_FP32_PER_S, n_bytes / PEAK_BYTES_PER_S) * 1e3
    rows["fused_inverted_residual"] = dict(
        max_abs_err=max_err, **tot, bound_by="operations",
        library="the port's eager InvertedResidual in eval on the widened x (TF32 off)")
    for k, r in rows.items():
        r["fp32_ms"] = perf[k]["ms"]
    return rows


def bf16_agreement(p: Predictor, ref: Predictor, frames, hold: bool = True) -> dict:
    """``p``'s logits against ``ref``'s on each batch's model input: the
    largest gap D and the logits' largest magnitude; the share of all
    pixels whose argmax agrees, and of those where ``ref``'s top-two margin
    exceeds BF16_MARGIN or 2 D (where no gap of D can flip the pick), with
    the shares of pixels above each margin. With ``hold``, D must be within
    BF16_LOGIT_TOL of the largest magnitude and the picks above 2 D equal;
    the logits fp32 and finite."""
    rows = []
    for f in frames:
        x = model_input(ref, f)
        with torch.inference_mode():
            a = p.model(x).permute(0, 2, 3, 1).float()
            b = ref.model(x).permute(0, 2, 3, 1).float()
        if not bool(a.isfinite().all()) or p.model(x[:1]).dtype != torch.float32:
            raise AssertionError("bf16 logits are not fp32 and finite")
        gap = float((a - b).abs().max())
        margin = top2_margin(b)
        same = a.argmax(-1) == b.argmax(-1)
        above, safe = margin > BF16_MARGIN, margin > 2 * gap
        share = lambda m: int(m.sum()) / m.numel()
        rows.append({"all": share(same), "above_margin": int(same[above].sum()) / max(
            1, int(above.sum())),
            "above_2gap": int(same[safe].sum()) / int(safe.sum()) if bool(safe.any()) else 1.0,
            "share_above_margin": share(above), "share_above_2gap": share(safe),
            "max_logit_gap": gap, "max_abs_logit": float(b.abs().max())})
    out = {k: min(r[k] for r in rows) for k in rows[0] if not k.startswith("max_")}
    out.update({k: max(r[k] for r in rows) for k in ("max_logit_gap", "max_abs_logit")})
    if hold and (out["max_logit_gap"] > BF16_LOGIT_TOL * out["max_abs_logit"]
                 or out["above_2gap"] != 1.0):
        raise AssertionError(f"bf16 routes' logits apart: {out}")
    return out


def bf16_serve(pth: Path, frames) -> tuple:
    """(b) The full-width flagship served in bf16 on the kernel route and
    the default route: the launches; each route's captured class maps
    bit-equal to its eager ones, and agreeing with a bf16 plain-path
    Predictor's on BF16_SERVED_AGREE of the pixels; the logits against
    that Predictor's (``bf16_agreement``) and, reported, the fp32 one's;
    frames/s, p50 and the captured device stage beside fp32's, in turns."""
    routes = {"kernels": KERNEL_FLAGS, "default": []}
    preds = {(r, dt): flagship(pth, flags + (BF16_FLAGS if dt == "bf16" else []))
             for r, flags in routes.items() for dt in ("fp32", "bf16")}
    ref = flagship(pth, PLAIN_FLAGS + BF16_FLAGS)
    out = {"served": {}}
    for r in routes:
        p = preds[(r, "bf16")]
        kernels.reset_launches()
        got = [p(f) for f in frames]
        launched = dict(kernels.launches)
        if r == "kernels":
            counts = launched
        with graphs.eager():
            want = [p(f) for f in frames]
        if not all(same_outputs(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"bf16 serve: route {r} captured differs from eager")
        replays = p._device_forward.replays()
        if replays != len(frames) - 1:
            raise AssertionError(f"bf16 serve: route {r} replayed {replays} times")
        if p.model.up1.conv.conv[0].compute_dtype != BF16:
            raise AssertionError(f"bf16 serve: route {r}'s model does not compute in bf16")
        agree, distinct = check_served(got, frames, ref, f"bf16 serve {r}")
        if len(distinct) < 2 or min(agree) < BF16_SERVED_AGREE:
            raise AssertionError(f"bf16 serve {r}: classes {sorted(distinct)}, agreement "
                                 f"{agree} with the bf16 plain path")
        out["served"][r] = {"captured_bit_equal_to_eager": True, "replays": replays,
                            "agreement_min_vs_bf16_plain": min(agree)}
    want = {k: 0 for k in counts}
    want.update(fused_upsample_concat_conv=4 * len(frames), argmax_colorize=len(frames))
    if counts != want:
        raise AssertionError(f"bf16 serve launches {counts}, expected {want}")
    out["launches"] = counts
    for r in routes:
        out[f"{r}_route_vs_bf16_plain"] = bf16_agreement(preds[(r, "bf16")], ref, frames)
    out["vs_fp32"] = bf16_agreement(preds[("kernels", "bf16")], preds[("kernels", "fp32")],
                                    frames, hold=False)
    timing = {}
    for r in routes:
        rows = {"fp32": [], "bf16": []}
        for dt in ("fp32", "bf16", "bf16", "fp32"):
            fps, p50 = timed(preds[(r, dt)], frames)
            rows[dt].append({"frames_per_s": fps, "p50_batch_ms": p50,
                             "device_stage_ms": stages(preds[(r, dt)], frames)["device"]})
        timing[r] = rows
    out["timing"] = timing
    del preds, ref
    torch.cuda.empty_cache()
    return out, counts


def bf16_train(train: dict) -> tuple:
    """(c) ``tpuseg_torch.main --model.compute_dtype=bfloat16
    --train.loss=lovasz``: the loss falls, both Lovász kernels launch once
    a step, 3 captured steps bit-equal to eager; the steady p50 beside the
    train phase's, and the device step against fp32 in turns."""
    from tpuseg_torch.main import main as train_main

    flags = BF16_FLAGS + ["--train.loss=lovasz"]
    argv = flags + ["--train.epochs=1", f"--train.steps_per_epoch={BF16_TRAIN_STEPS}",
                    "--data.val_split=0", "--train.checkpoint_dir=", "--train.log_every=0"]
    kernels.reset_launches()
    tr = train_main(argv)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    want = {k: 0 for k in counts}
    want.update(lovasz_histograms=BF16_TRAIN_STEPS, lovasz_lookup=BF16_TRAIN_STEPS)
    if counts != want or tr.step != BF16_TRAIN_STEPS:
        raise AssertionError(f"bf16 train launches {counts} after {tr.step} steps")
    losses = tr.step_losses
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not all(math.isfinite(v) for v in losses) or not last < first:
        raise AssertionError(f"bf16 train losses: first 5 {first}, last 5 {last}")
    if {p.dtype for p in tr.model.parameters()} != {torch.float32}:
        raise AssertionError("bf16 training changed the parameters' dtype")
    lat = []
    gen = tr.pipeline.train_batches(TIMED_STEPS)
    while True:
        t0 = time.perf_counter()
        batch = next(gen, None)
        if batch is None:
            break
        tr.train_step(*batch)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    steady = lat[3:]
    del tr, gen
    out = {"launches": counts, "steps": BF16_TRAIN_STEPS, "loss_first5": first,
           "loss_last5": last, "losses_every10": losses[::10],
           "p50_step_ms": float(np.median(steady)) * 1e3,
           "steady_imgs_per_s": BATCH * len(steady) / sum(steady),
           "fp32_train_phase": {k: train[k] for k in ("p50_step_ms", "steady_imgs_per_s")}}
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        out["captured_vs_eager"] = train_ab(flags, "bf16", lovasz=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    rows = {"fp32": [], "bf16": []}
    for dt in ("fp32", "bf16", "bf16", "fp32"):
        rows[dt].append(train_timing(["--train.loss=lovasz"]
                                     + (BF16_FLAGS if dt == "bf16" else []), 1, False))
    out["timing"] = rows
    return out, counts


def bf16_options() -> tuple:
    """(d) A short bf16 run each with --train.mu_dtype=bfloat16 and with
    --train.grads_bf16=true: the state's dtypes, finite losses."""
    from tpuseg_torch.main import main as train_main

    out, total = {}, {}
    for label, flag in (("mu_dtype", "--train.mu_dtype=bfloat16"),
                        ("grads_bf16", "--train.grads_bf16=true")):
        kernels.reset_launches()
        tr = train_main(BF16_FLAGS + [flag, "--train.loss=lovasz", "--train.epochs=1",
                                      f"--train.steps_per_epoch={BF16_OPTION_STEPS}",
                                      "--data.val_split=0", "--train.checkpoint_dir=",
                                      "--train.log_every=0"])
        torch.cuda.synchronize()
        for k, v in kernels.launches.items():
            total[k] = total.get(k, 0) + v
        mu = {str(t.dtype) for t in tr.optimizer.state["mu"]}
        nu = {str(t.dtype) for t in tr.optimizer.state["nu"]}
        params = {str(p.dtype) for p in tr.model.parameters()}
        want_mu = {"torch.bfloat16"} if label == "mu_dtype" else {"torch.float32"}
        if mu != want_mu or nu != {"torch.float32"} or params != {"torch.float32"} or \
                tr.step != BF16_OPTION_STEPS or not all(map(math.isfinite, tr.step_losses)):
            raise AssertionError(f"bf16 {label}: mu {mu}, nu {nu}, params {params}, "
                                 f"losses {tr.step_losses}")
        out[label] = {"mu": sorted(mu), "nu": sorted(nu), "params": sorted(params),
                      "losses": tr.step_losses}
        del tr
    return out, total


def phase_bf16(perf, train: dict) -> dict:
    """bf16 compute on the slice's paths: (a) the kernels, (b) serving,
    (c) training, (d) the optimizer options."""
    out = {"phase": "bf16", "kernels": bf16_kernel_rows(perf)}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        pth = Path(tmp) / "weights.pth"
        seeded_weights(load_config([]), pth)
        out["serve"], serve_counts = bf16_serve(pth, serve_frames())
    out["train"], train_counts = bf16_train(train)
    out["options"], option_counts = bf16_options()
    out["path_launches"] = {k: serve_counts[k] + train_counts[k] + option_counts.get(k, 0)
                            for k in serve_counts}
    emit(out)
    return out


# the mesh phase: two ranks sharing the card over gloo (on a machine of one
# card; NCCL refuses two ranks of one communicator on one device)
MESH_RANKS, MESH_STEPS, MESH_TIMED, MESH_AB_STEPS, MESH_REPS = 2, 20, 10, 3, 20
MESH_ROUTE = "2 ranks sharing one card, gloo, eager"


MESH_FLAGS = ["--train.loss=ce+lovasz", "--train.epochs=1", "--train.checkpoint_dir=",
              "--train.log_every=0"]
# two ranks against one process over MESH_AB_STEPS eager Adam steps from one
# state on the same batches. The loss and BatchNorm sums are taken over two
# halves (BatchNorm's variance by flax's E[x^2] - E[x]^2, one process's by
# torch's), so the first step's loss and statistics agree to fp32 rounding.
MESH_AB_FIRST_LOSS_RTOL = 1e-5
# after the first step, each running mean within this share of its channel's
# standard deviation and each running variance within this share of itself
# (E[x^2] - E[x]^2 in fp32 loses about eps * mean^2 / var; 4.5e-5 measured at
# width 0.25 on a CPU)
MESH_AB_FIRST_STATS_TOL = 1e-3
# the first step's parameter gradients, summed over the ranks, against one
# process's on the same batch: per parameter, |g_ranks - g_one| / |g_one|
# (Frobenius norms) over the parameters that carry at least
# MESH_GRAD_FLOOR of the largest one's norm (below it a gradient is fp32
# noise of a sum that cancels, as a conv bias's ahead of a BatchNorm).
# Readings: 0.0168 on the card, 0.030 at width 0.25 on a CPU (the binned
# Lovász's gradient jumps where fp32 rounding moves an error across a bin
# edge, and BatchNorm's backward cancels). A gradient scaled by the world
# size, or a rank's part lost, gives 0.5 to 1; the same check of the
# summed gradients doubled must fail it (reading 1.005).
MESH_AB_GRAD_RTOL = 5e-2
MESH_GRAD_FLOOR = 1e-3
# Adam moves a parameter by about lr whatever its gradient's size, so one
# whose gradient is rounding noise may move by up to 2 lr a step apart:
# 3 x 2 x 1.5e-4 = 9e-4 after 3 steps; this check sees only a gross fault.
MESH_AB_PARAM_ATOL = 1e-3
# the later losses follow from parameters that far apart (readings on the
# card 3.5e-6 to 9e-5 relative)
MESH_AB_LOSS_RTOL = 3e-4
# the sharded op against the one-process kernel route: w is the same lookup
# of the same coefficients, and the softmax chain is per pixel
MESH_GRAD_ATOL = 1e-6


def mesh_route(ranks: int) -> tuple:
    """(label, backend) of ``ranks`` ranks on this host: one card each over
    NCCL where there are as many, else sharing card 0 over gloo."""
    if torch.cuda.device_count() >= ranks:
        return f"{ranks} ranks, one card each, NCCL, eager", "nccl"
    if ranks == MESH_RANKS:
        return MESH_ROUTE, "gloo"
    return f"{ranks} ranks sharing one card, gloo, eager", "gloo"


def mesh_timed(fn, reps: int = MESH_REPS) -> float:
    """Host-clock ms of ``fn()`` ending in a synchronize (a gloo collective
    syncs the host anyway), median over ``reps`` after two warm-ups."""
    lat = []
    for i in range(reps + 2):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(lat[2:]))


def mesh_rank(device, logits_np, targets_np, flags, n_ranks) -> dict:
    """One rank of the mesh phase (a spawned process on ``device``)."""
    import hashlib

    from tpuseg_torch.core.mesh import all_reduce_, batch_slice, create_mesh
    from tpuseg_torch.main import main as train_main
    from tpuseg_torch.ops.lovasz import (lovasz_histograms, lovasz_histograms_plain,
                                         lovasz_lookup, lovasz_lookup_plain,
                                         make_sharded_lovasz, sharded_lovasz_parts)

    mesh = create_mesh(n_ranks, 1)
    rows = batch_slice(mesh, logits_np.shape[0])[0]
    lg = torch.from_numpy(logits_np[rows]).to(device)
    tg = torch.from_numpy(targets_np[rows]).to(device)
    kern, plain = (lovasz_histograms, lovasz_lookup), (lovasz_histograms_plain,
                                                       lovasz_lookup_plain)
    out = {"rank": mesh.rank, "backend": mesh.backend, "rows": [rows.start, rows.stop]}

    # (a) the sharded Lovász on this rank's rows: the kernel route, its plain
    # version, and the autograd op
    kernels.reset_launches()
    value, coef, grad = sharded_lovasz_parts(lg, tg, mesh, False, None, *kern)
    torch.cuda.synchronize()
    out["launches_per_call"] = {k: v for k, v in kernels.launches.items() if v}
    value_p, coef_p, grad_p = sharded_lovasz_parts(lg, tg, mesh, False, None, *plain)
    x = lg.clone().requires_grad_(True)
    op_value = make_sharded_lovasz(mesh)(x, tg)
    op_value.backward()
    out.update(value=float(value), coef=coef.cpu().numpy(), grad=grad.cpu().numpy(),
               value_plain=float(value_p), coef_plain=coef_p.cpu().numpy(),
               grad_plain_diff=float((grad_p - grad).abs().max()),
               op_value=float(op_value.detach()),
               op_grad_diff=float((x.grad - grad).abs().max()))
    hist = torch.zeros((3, CLASSES, 256), device=device)
    ins = copies(lambda i: (lg.clone(), tg.clone()), lg.numel() * 4 + tg.numel() * 8)
    out["ms"] = {
        "region": mesh_timed(lambda: sharded_lovasz_parts(lg, tg, mesh, False, None, *kern)),
        "region_plain": mesh_timed(
            lambda: sharded_lovasz_parts(lg, tg, mesh, False, None, *plain)),
        "all_reduce": mesh_timed(lambda: all_reduce_(hist, mesh, mesh.data_group)),
        "local": device_ms(lambda a, b: sharded_lovasz_parts(a, b, None, False, None, *kern),
                           ins),
        "local_plain": device_ms(
            lambda a, b: sharded_lovasz_parts(a, b, None, False, None, *plain), ins)}
    del ins

    # (b) the flagship trained through the entry point over the mesh
    kernels.reset_launches()
    tr = train_main(flags)
    torch.cuda.synchronize()
    out["launches"] = {k: v for k, v in kernels.launches.items() if v}
    digest = hashlib.sha256()
    for k, v in tr.model.state_dict().items():
        digest.update(v.cpu().numpy().tobytes())
    out.update(losses=tr.step_losses, steps=tr.step, digest=digest.hexdigest(),
               val_miou=tr.history[-1].get("val_miou"), mesh=str(tr.mesh),
               captured=hasattr(tr.train_step, "replays"))
    lat = []
    for batch in tr.pipeline.train_batches(MESH_TIMED):
        t0 = time.perf_counter()
        tr.train_step(*batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    out["p50_step_ms"] = float(np.median(lat[2:]))
    del tr
    out["ab"] = mesh_ab_run([f"--mesh.data={n_ranks}"], keep=mesh.rank == 0)
    return out


def mesh_ab_run(flags, keep: bool) -> dict:
    """MESH_AB_STEPS eager steps of a fresh Trainer (ce+lovasz) on its own
    seeded batches: the losses, and (``keep``) the first step's parameter
    gradients (over a mesh, as summed across the ranks for the update) and
    the state after the first and the last step, as numpy."""
    tr = graph_trainer(["--train.loss=ce+lovasz", *flags])
    out = {"losses": []}
    with graphs.eager():
        for i, batch in enumerate(draw_batches(tr, MESH_AB_STEPS)):
            out["losses"].append(float(tr.train_step(*batch)["loss"]))
            if keep and i == 0:
                out["grads1"] = {k: p.grad.cpu().numpy().copy()
                                 for k, p in tr.model.named_parameters() if p.grad is not None}
            if keep and i in (0, MESH_AB_STEPS - 1):
                out[f"state{i + 1}"] = {k: v.cpu().numpy().copy()
                                        for k, v in tr.model.state_dict().items()
                                        if not k.endswith("num_batches_tracked")}
    del tr
    return out


def grad_rdiff(got: dict, want: dict) -> float:
    """The largest |got - want| / |want| (Frobenius norms) over the
    parameters whose ``want`` norm is at least MESH_GRAD_FLOOR of the
    largest; every parameter of ``want`` must be in ``got``."""
    if set(got) != set(want):
        raise AssertionError(f"mesh: gradients of {sorted(set(got) ^ set(want))} on one side")
    norms = {k: float(np.linalg.norm(v.astype(np.float64))) for k, v in want.items()}
    floor = MESH_GRAD_FLOOR * max(norms.values())
    return max(float(np.linalg.norm(got[k].astype(np.float64) - want[k])) / n
               for k, n in norms.items() if n >= floor)


def _max_diff(a: dict, b: dict, keys) -> float:
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in keys)


def _stats_diff(a: dict, b: dict, keys) -> float:
    """The largest BatchNorm statistic difference, a mean's in units of its
    channel's standard deviation and a variance's in units of itself."""
    def scale(k):
        var = b[k.replace("running_mean", "running_var")].astype(np.float64)
        return np.sqrt(var) if k.endswith("running_mean") else var

    return max(float((np.abs(a[k].astype(np.float64) - b[k]) / scale(k)).max()) for k in keys)


def phase_mesh(n_ranks: int = MESH_RANKS) -> dict:
    """Data parallelism on the card (see the module): the sharded Lovász
    per rank against the one-process kernel route, and the flagship
    trained over ``n_ranks`` ranks against one process. With one card the
    ranks share it over gloo; with a card per rank they take one each
    over NCCL."""
    from tpuseg_torch.core.mesh import launch_local
    from tpuseg_torch.ops.lovasz import lovasz_histograms, lovasz_lookup, sharded_lovasz_parts

    rng = np.random.RandomState(SEED)
    logits = (rng.randn(BATCH, *MODEL_HW, CLASSES) * 2).astype(np.float32)
    targets = rng.randint(0, CLASSES, (BATCH, *MODEL_HW))
    # the one-process kernel route on the whole batch (this builds nothing:
    # the build phase did, so the ranks load the same libraries)
    value, coef, grad = sharded_lovasz_parts(
        torch.from_numpy(logits).cuda(), torch.from_numpy(targets).cuda(), None, False, None,
        lovasz_histograms, lovasz_lookup)
    coef, grad = coef.cpu().numpy(), grad.cpu().numpy()
    route, backend = mesh_route(n_ranks)
    flags = [f"--mesh.data={n_ranks}", *MESH_FLAGS, f"--train.steps_per_epoch={MESH_STEPS}",
             f"--data.val_split={VAL_SPLIT}"]
    t0 = time.perf_counter()
    ranks = launch_local(mesh_rank, n_ranks, device="cuda", timeout_s=600,
                         args=(logits, targets, flags, n_ranks))
    wall = time.perf_counter() - t0

    lovasz_rows, train_rows = [], []
    for r in ranks:
        lo, hi = r["rows"]
        row = {"rank": r["rank"], "launches_per_call": r["launches_per_call"],
               "coef_bit_equal": bool(np.array_equal(r["coef"], coef)),
               "coef_plain_bit_equal": bool(np.array_equal(r["coef_plain"], r["coef"])),
               "value_diff": abs(r["value"] - float(value)),
               "value_plain_diff": abs(r["value_plain"] - r["value"]),
               "op_value_diff": abs(r["op_value"] - r["value"]),
               "grad_diff": float(np.abs(r["grad"] - grad[lo:hi]).max()),
               "grad_plain_diff": r["grad_plain_diff"], "op_grad_diff": r["op_grad_diff"],
               "ms": r["ms"]}
        lovasz_rows.append(row)
        if (row["launches_per_call"] != {"lovasz_histograms": 1, "lovasz_lookup": 1}
                or not row["coef_bit_equal"] or not row["coef_plain_bit_equal"]
                or max(row["value_diff"], row["value_plain_diff"],
                       row["op_value_diff"]) > LOVASZ_VALUE_ATOL
                or max(row["grad_diff"], row["grad_plain_diff"]) > MESH_GRAD_ATOL
                or row["op_grad_diff"] != 0.0):
            raise AssertionError(f"mesh: the sharded Lovász on rank {r['rank']}: {row}")
        losses = r["losses"]
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        want = {"lovasz_histograms": MESH_STEPS, "lovasz_lookup": MESH_STEPS}
        if (r["launches"] != want or r["steps"] != MESH_STEPS or r["captured"]
                or r["backend"] != backend or not all(math.isfinite(x) for x in losses)
                or not last < first or not math.isfinite(r["val_miou"] or float("nan"))):
            raise AssertionError(f"mesh: rank {r['rank']} trained {r['steps']} steps, "
                                 f"launches {r['launches']}, losses {losses}")
        train_rows.append({"rank": r["rank"], "launches": r["launches"], "loss_first5": first,
                           "loss_last5": last, "val_miou": r["val_miou"],
                           "p50_step_ms": r["p50_step_ms"], "mesh": r["mesh"]})
    r0 = ranks[0]
    if any(r["digest"] != r0["digest"] or r["losses"] != r0["losses"]
           or r["ab"]["losses"] != r0["ab"]["losses"] for r in ranks):
        raise AssertionError("mesh: the ranks' parameters or losses differ")

    # the same steps in one process, from the same state on the same batches
    one, two = mesh_ab_run([], keep=True), r0["ab"]
    stats = [k for k in one["state1"] if k.endswith(("running_mean", "running_var"))]
    params = [k for k in one["state1"] if k not in stats]
    loss_rdiff = [abs(a - b) / abs(b) for a, b in zip(two["losses"], one["losses"])]
    ab = {"steps": MESH_AB_STEPS, "mesh_losses": two["losses"],
          "one_process_losses": one["losses"], "loss_rdiff": loss_rdiff,
          "first_step_stats_scaled_diff": _stats_diff(two["state1"], one["state1"], stats),
          "first_step_grad_rdiff": grad_rdiff(two["grads1"], one["grads1"]),
          "planted_x2_grad_rdiff": grad_rdiff({k: 2 * v for k, v in two["grads1"].items()},
                                              one["grads1"]),
          "max_param_diff": _max_diff(two[f"state{MESH_AB_STEPS}"],
                                      one[f"state{MESH_AB_STEPS}"], params),
          "last_step_stats_max_diff": _max_diff(two[f"state{MESH_AB_STEPS}"],
                                                one[f"state{MESH_AB_STEPS}"], stats),
          "tolerances": {"first_loss_rtol": MESH_AB_FIRST_LOSS_RTOL,
                         "first_stats_scaled": MESH_AB_FIRST_STATS_TOL,
                         "grad_rtol": MESH_AB_GRAD_RTOL, "grad_floor": MESH_GRAD_FLOOR,
                         "loss_rtol": MESH_AB_LOSS_RTOL, "param_atol": MESH_AB_PARAM_ATOL}}
    if (loss_rdiff[0] > MESH_AB_FIRST_LOSS_RTOL or max(loss_rdiff) > MESH_AB_LOSS_RTOL
            or ab["first_step_stats_scaled_diff"] > MESH_AB_FIRST_STATS_TOL
            or ab["first_step_grad_rdiff"] > MESH_AB_GRAD_RTOL
            or ab["planted_x2_grad_rdiff"] <= MESH_AB_GRAD_RTOL
            or ab["max_param_diff"] > MESH_AB_PARAM_ATOL):
        raise AssertionError(f"mesh: {n_ranks} ranks against one process: {ab}")

    # the region's bound: this rank's logits (f32) and targets (int64) read
    # once, the logits gradient (f32) written once
    pixels = (BATCH // n_ranks) * MODEL_HW[0] * MODEL_HW[1]
    bound, bound_by = bound_ms(pixels * CLASSES * 4 + pixels * targets.itemsize
                               + pixels * CLASSES * 4, 0)
    out = {"phase": "mesh", "route": route, "ranks": n_ranks,
           "collectives": ("gloo, CUDA tensors staged through host memory"
                           if backend == "gloo" else "NCCL on the cards"),
           "wall_s": wall, "sharded_lovasz": lovasz_rows,
           "region_shape_per_rank": [CLASSES, pixels],
           "region_bound_ms": bound, "region_bound_by": bound_by,
           "train": train_rows, "params_bit_equal_across_ranks": True,
           "p50_step_ms": {"label": route,
                           "per_rank": [r["p50_step_ms"] for r in ranks]},
           "vs_one_process": ab}
    emit(out)
    return out


# the spatial phase: the flagship with its image height sharded over two
# ranks (64-row slabs of the 256x128 frame), then data 2 x spatial 2
SPATIAL_STEPS, SPATIAL_TIMED, SPATIAL_FETCH_STEPS, SPATIAL_AB_STEPS = 20, 8, 2, 3
SPATIAL_FLAGS = ["--train.loss=ce+lovasz", "--train.epochs=1", "--train.checkpoint_dir=",
                 "--train.log_every=0"]
# the train-mode logits assembled from the slabs against one process's at
# step 1, in units of their largest magnitude: the same function, its
# float32 sums (BatchNorm's over two halves) in another order
SPATIAL_LOGITS_TOL = 1e-3
# the first loss against one process's (the mesh phase reads 1e-5-level gaps)
SPATIAL_LOSS_RTOL = 1e-4
# each rank's activation peak (a step's max_memory_allocated less what was
# allocated before it) against one process's at the same global batch, both
# measured on the last A/B step (a fresh Trainer, eager): the activations
# sharded, not replicated, allow at most this share (the subpixel
# decoder's composite kernels, ~65 MB saved for the backward, do not shard)
SPATIAL_MEMORY_RATIO = 0.75


def spatial_ab_run(flags, keep: bool, steps: int) -> dict:
    """``steps`` eager steps of a fresh Trainer (ce+lovasz) on its own seeded
    batches: the losses, the first step's train-mode logits (this rank's
    slab, NCHW), the launches, (``keep``) the first step's summed
    gradients, the last step's activation peak, and the digest of the
    state after the last step."""
    import hashlib

    tr = graph_trainer(["--train.loss=ce+lovasz", *flags])
    seen = []
    hook = tr.model.register_forward_hook(
        lambda m, i, o: seen.append(o.detach().cpu().numpy()) if not seen else None)
    out = {"losses": []}
    kernels.reset_launches()
    with graphs.eager():
        for i, batch in enumerate(draw_batches(tr, steps)):
            if i == steps - 1:
                out["activation_peak_mb"] = activation_peak_mb(
                    lambda: out["losses"].append(float(tr.train_step(*batch)["loss"])))
            else:
                out["losses"].append(float(tr.train_step(*batch)["loss"]))
            if keep and i == 0:
                out["grads1"] = {k: p.grad.cpu().numpy().copy()
                                 for k, p in tr.model.named_parameters() if p.grad is not None}
    torch.cuda.synchronize()
    hook.remove()
    out["launches"] = {k: v for k, v in kernels.launches.items() if v}
    out["logits1"] = seen[0]
    digest = hashlib.sha256()
    for k, v in tr.model.state_dict().items():
        digest.update(v.cpu().numpy().tobytes())
    out["digest"] = digest.hexdigest()
    del tr
    return out


def activation_peak_mb(step) -> float:
    """The device memory a call of ``step`` allocates at its peak beyond
    what was allocated before it (parameters, gradients, optimizer state,
    the batch), MiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def fetch_timer():
    """Wrap the row fetch's forward and backward in host-clock timers (each
    synchronized); returns (the list of ms they append to, undo)."""
    from tpuseg_torch.parallel import spatial

    fn = spatial._FetchRows
    fwd, bwd, spent = fn.forward, fn.backward, []

    def timed(inner):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize()
            spent.append((time.perf_counter() - t0) * 1e3)
            return out
        return staticmethod(call)

    fn.forward, fn.backward = timed(fwd), timed(bwd)

    def undo():
        fn.forward, fn.backward = staticmethod(fwd), staticmethod(bwd)

    return spent, undo


def spatial_rank(device, flags, logits_np, targets_np) -> dict:
    """One rank of the spatial phase's two (a spawned process on
    ``device``): the flagship trained through the entry point with the
    image height over the ranks, timed; its fetches and the sharded Lovász
    region timed; then the A/B steps against one process."""
    from tpuseg_torch.core.mesh import batch_slice, create_mesh
    from tpuseg_torch.main import main as train_main
    from tpuseg_torch.ops.lovasz import lovasz_histograms, lovasz_lookup, sharded_lovasz_parts

    fp32_exact()
    mesh = create_mesh(1, 2)
    index = batch_slice(mesh, logits_np.shape[:2], 1)
    lg = torch.from_numpy(logits_np[index]).to(device)
    tg = torch.from_numpy(targets_np[index]).to(device)
    out = {"rank": mesh.rank, "backend": mesh.backend, "slab": [index[1].start, index[1].stop],
           "region_ms": mesh_timed(lambda: sharded_lovasz_parts(
               lg, tg, mesh, True, None, lovasz_histograms, lovasz_lookup))}
    kernels.reset_launches()
    tr = train_main(flags)
    torch.cuda.synchronize()
    out["launches"] = {k: v for k, v in kernels.launches.items() if v}
    out.update(losses=tr.step_losses, steps=tr.step, spatial=tr.spatial, mesh=str(tr.mesh),
               val_miou=tr.history[-1].get("val_miou"),
               captured=hasattr(tr.train_step, "replays"))
    batches = list(tr.pipeline.train_batches(SPATIAL_TIMED + SPATIAL_FETCH_STEPS))
    lat = []
    for batch in batches[:SPATIAL_TIMED]:
        t0 = time.perf_counter()
        tr.train_step(*batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    out["p50_step_ms"] = float(np.median(lat[2:]))
    spent, undo = fetch_timer()
    try:
        for batch in batches[SPATIAL_TIMED:]:
            tr.train_step(*batch)
    finally:
        undo()
    out["fetches_per_step"] = len(spent) // SPATIAL_FETCH_STEPS
    out["fetch_ms_per_step"] = sum(spent) / SPATIAL_FETCH_STEPS
    del tr, batches
    out["ab"] = spatial_ab_run(["--mesh.data=1", "--mesh.spatial=2"], keep=mesh.rank == 0,
                               steps=SPATIAL_AB_STEPS)
    return out


def fp32_exact() -> None:
    """TF32 off for cuDNN and matmul, as main() and the entry point set it
    (a spawned rank starts with PyTorch's defaults)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def combined_rank(device) -> dict:
    """One rank of data 2 x spatial 2: the A/B steps against one process."""
    from tpuseg_torch.core.mesh import create_mesh

    fp32_exact()
    mesh = create_mesh(2, 2)
    out = spatial_ab_run(["--mesh.data=2", "--mesh.spatial=2"], keep=mesh.rank == 0,
                         steps=SPATIAL_AB_STEPS)
    out["coords"] = mesh.coords
    return out


def lovasz_shape_check(p: int, seed: int, what: str) -> dict:
    """lovasz_histograms and lovasz_lookup at [C, p], a shape a path gives
    them (its own pixels a block), against their plain versions: counts, fg sums and w bit-equal, error sums within
    ERRSUM_RTOL of f64."""
    from tpuseg_torch.ops import lovasz

    c = LOVASZ_SHAPE[0]
    e, fg = lovasz_planes(seed, p)
    hk, hp = lovasz.lovasz_histograms(e, fg), lovasz.lovasz_histograms_plain(e, fg)
    h64 = lovasz.lovasz_histograms_plain(e.double(), fg.double())
    coef, _ = lovasz.coefficients(*hp)
    wk, wp = lovasz.lovasz_lookup(e, coef), lovasz.lovasz_lookup_plain(e, coef)
    torch.cuda.synchronize()
    err = (hk[2] - hp[2]).abs()
    if not (torch.equal(hk[0], hp[0]) and torch.equal(hk[1], hp[1]) and torch.equal(wk, wp)) \
            or bool((err > ERRSUM_RTOL * h64[2].abs() + 1e-7).any()):
        raise AssertionError(f"{what}: the Lovász kernels at [{c}, {p}] differ from their "
                             f"plain versions (error sums {float(err.max())})")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"shape": [c, p], "blocks_per_class": lovasz.lovasz_hist_plan(c, p, sms),
            "counts_fg_w_bit_equal": True, "errsum_max_abs_err": float(err.max())}


def spatial_vs_one(ranks_ab, one: dict, slabs, what: str) -> dict:
    """Step 1 of the ranks (``ranks_ab``: each rank's spatial_ab_run, its H
    slab in ``slabs``) against one process's: logits, summed gradients,
    loss; the ranks' losses and parameters bit-equal among themselves."""
    r0 = ranks_ab[0]
    if any(r["digest"] != r0["digest"] or r["losses"] != r0["losses"] for r in ranks_ab):
        raise AssertionError(f"spatial {what}: the ranks' parameters or losses differ")
    want = one["logits1"]
    got = np.zeros_like(want)
    for r, (rows, (lo, hi)) in zip(ranks_ab, slabs):
        got[rows, :, lo:hi] = r["logits1"]
    scale = float(np.abs(want).max())
    out = {"logits_diff_over_max": float(np.abs(got - want).max()) / scale,
           "loss1_rdiff": abs(r0["losses"][0] - one["losses"][0]) / abs(one["losses"][0]),
           "losses": r0["losses"], "one_process_losses": one["losses"][:len(r0["losses"])],
           "first_step_grad_rdiff": grad_rdiff(r0["grads1"], one["grads1"]),
           "planted_x2_grad_rdiff": grad_rdiff({k: 2 * v for k, v in r0["grads1"].items()},
                                               one["grads1"]),
           "params_bit_equal_across_ranks": True}
    if (out["logits_diff_over_max"] > SPATIAL_LOGITS_TOL
            or out["loss1_rdiff"] > SPATIAL_LOSS_RTOL
            or out["first_step_grad_rdiff"] > MESH_AB_GRAD_RTOL
            or out["planted_x2_grad_rdiff"] <= MESH_AB_GRAD_RTOL):
        raise AssertionError(f"spatial {what} against one process: {out}")
    return out


def phase_spatial(packed: str) -> dict:
    """The spatially sharded train step on the card (see the module)."""
    from tpuseg_torch.core.mesh import launch_local

    out = {"phase": "spatial",
           "lovasz_slab": lovasz_shape_check(LOVASZ_SHAPE[1] // 2, 700, "spatial")}
    rng = np.random.RandomState(SEED)
    logits = (rng.randn(BATCH, *MODEL_HW, CLASSES) * 2).astype(np.float32)
    targets = rng.randint(0, CLASSES, (BATCH, *MODEL_HW))
    route, backend = mesh_route(2)
    flags = ["--mesh.data=1", "--mesh.spatial=2", *SPATIAL_FLAGS, packed_source_flag(packed),
             f"--train.steps_per_epoch={SPATIAL_STEPS}", f"--data.val_split={VAL_SPLIT}"]
    t0 = time.perf_counter()
    ranks = launch_local(spatial_rank, 2, device="cuda", timeout_s=600,
                         args=(flags, logits, targets))
    out["wall_s"] = time.perf_counter() - t0

    # one process on the same batches, uncaptured as the ranks' steps are
    one = spatial_ab_run([], keep=True, steps=SPATIAL_AB_STEPS)
    one_peak = one["activation_peak_mb"]

    rows = []
    for r in ranks:
        losses = r["losses"]
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        want = {"lovasz_histograms": SPATIAL_STEPS, "lovasz_lookup": SPATIAL_STEPS}
        ratio = r["ab"]["activation_peak_mb"] / one_peak
        row = {"rank": r["rank"], "slab_rows": r["slab"], "launches": r["launches"],
               "loss_first5": first, "loss_last5": last, "val_miou": r["val_miou"],
               "p50_step_ms": r["p50_step_ms"], "lovasz_region_ms": r["region_ms"],
               "fetches_per_step": r["fetches_per_step"],
               "fetch_ms_per_step": r["fetch_ms_per_step"],
               "activation_peak_mb": r["ab"]["activation_peak_mb"],
               "one_process_activation_peak_mb": one_peak, "activation_ratio": ratio,
               "mesh": r["mesh"]}
        if (r["launches"] != want or r["steps"] != SPATIAL_STEPS or not r["spatial"]
                or r["captured"] or r["backend"] != backend
                or not all(math.isfinite(x) for x in losses) or not last < first
                or not math.isfinite(r["val_miou"] or float("nan"))
                or ratio > SPATIAL_MEMORY_RATIO):
            raise AssertionError(f"spatial: rank {r['rank']}: {row}, losses {losses}")
        rows.append(row)
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError("spatial: the ranks' losses differ")
    out.update(route=route, ranks=2, frame=list(MODEL_HW), batch=BATCH, train=rows,
               vs_one_process=spatial_vs_one(
                   [r["ab"] for r in ranks], one,
                   [(slice(None), r["slab"]) for r in ranks], "data 1 x spatial 2"))

    route4, _ = mesh_route(4)
    t0 = time.perf_counter()
    four = launch_local(combined_rank, 4, device="cuda", timeout_s=600)
    half_b, half_h = BATCH // 2, MODEL_HW[0] // 2
    slabs = [(slice(r["coords"]["data"] * half_b, (r["coords"]["data"] + 1) * half_b),
              (r["coords"]["spatial"] * half_h, (r["coords"]["spatial"] + 1) * half_h))
             for r in four]
    ratios = [r["activation_peak_mb"] / one_peak for r in four]
    out["combined"] = {"route": route4, "ranks": 4, "wall_s": time.perf_counter() - t0,
                       "launches_per_rank": [r["launches"] for r in four],
                       "activation_peak_mb": [r["activation_peak_mb"] for r in four],
                       "activation_ratio": ratios,
                       "vs_one_process": spatial_vs_one(four, one, slabs,
                                                        "data 2 x spatial 2")}
    want = {"lovasz_histograms": SPATIAL_AB_STEPS, "lovasz_lookup": SPATIAL_AB_STEPS}
    if max(ratios) > SPATIAL_MEMORY_RATIO or any(r["launches"] != want for r in four):
        raise AssertionError(f"spatial data 2 x spatial 2: activation ratios {ratios}, "
                             f"launches {[r['launches'] for r in four]}")
    emit(out)
    return out


# the graphs phase: the options configuration of its second train A/B, the
# steps of each A/B and timing, and K of the multi-step dispatch
GRAPH_OPTIONS = ["--train.optimizer=adamw", "--train.lr_schedule=cosine",
                 "--train.warmup_steps=2", "--train.grad_accum=2",
                 "--train.grad_clip_norm=1.0", "--train.ema_decay=0.9"]
GRAPH_AB_STEPS, GRAPH_TIMED, GRAPH_K, PROFILE_STEPS = 3, 20, 4, 5


def graph_trainer(flags):
    """A Trainer of the slice's configuration (full width, batch 8,
    256x128, synthetic scenes unless ``flags`` name sources), with
    ``flags`` on top; no checkpoints."""
    from tpuseg_torch.main import default_sources
    from tpuseg_torch.train.trainer import Trainer

    cfg = load_config(["--train.checkpoint_dir=", "--data.val_split=0", "--train.epochs=1",
                       "--train.log_every=0", *flags])
    if not cfg.data.sources:
        cfg.data.sources = default_sources(cfg)
    return Trainer(cfg)


def draw_batches(tr, n: int):
    """``n`` device batches from the Trainer's own seeded sampler."""
    pipe = tr.pipeline
    return [pipe._put(pipe._assemble(pipe.sampler.sample(tr.cfg.train.batch_size)))
            for _ in range(n)]


def dispatch(tr, group):
    """One call of the Trainer's step on a group of batches (1 or K)."""
    if len(group) == 1:
        return tr.train_step(*group[0])
    return tr.train_step(torch.stack([g[0] for g in group]), torch.stack([g[1] for g in group]))


def train_snapshot(tr) -> dict:
    """Everything a step moves: parameters, BatchNorm statistics, optimizer
    state and EMA (device copies), and the augmentation generator."""
    snap = {f"model.{k}": v.detach().clone() for k, v in tr.model.state_dict().items()}
    for k, v in tr.optimizer.state.items():
        for i, t in enumerate(v if isinstance(v, list) else [v]):
            snap[f"optimizer.{k}.{i}"] = t.detach().clone()
    snap["generator"] = tr.aug_generator.get_state()
    return snap


def train_run(flags, steps: int, eager: bool, k: int = 1):
    """(losses, snapshot, replays) of ``steps`` steps of a fresh Trainer,
    dispatched in groups of ``k``, captured or under graphs.eager()."""
    tr = graph_trainer(flags + ([f"--train.steps_per_dispatch={k}"] if k > 1 else []))
    batches = draw_batches(tr, steps)
    losses = []
    kernels.reset_launches()
    with graphs.eager() if eager else contextlib.nullcontext():
        for i in range(0, steps, k):
            losses += np.atleast_1d(dispatch(tr, batches[i:i + k])["loss"].cpu().numpy()).tolist()
    torch.cuda.synchronize()
    replays = 0 if eager else tr.train_step.replays()
    counts = {k: v for k, v in kernels.launches.items() if v}
    out = (losses, train_snapshot(tr), replays, counts)
    del tr
    return out


def snapshot_diff(a: dict, b: dict) -> dict:
    differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
    return {"tensors": len(a), "differ": differ[:8], "n_differ": len(differ),
            "max_abs_diff": max([float((a[k].double() - b[k].double()).abs().max())
                                 for k in differ] + [0.0])}


def train_ab(flags, label: str, lovasz: bool) -> dict:
    """Captured against eager, GRAPH_AB_STEPS steps from one seeded state,
    deterministic algorithms: the state bit-equal. The Lovász loss value
    sums its error histogram with float atomics, so its low bits move from
    run to run; it is held to LOVASZ_VALUE_ATOL, and any other loss must be
    bit-equal."""
    cap_l, cap_s, replays, cap_n = train_run(flags, GRAPH_AB_STEPS, eager=False)
    eag_l, eag_s, _, eag_n = train_run(flags, GRAPH_AB_STEPS, eager=True)
    row = {"flags": flags, "steps": GRAPH_AB_STEPS, "replays": replays,
           "launches_captured": cap_n, "launches_eager": eag_n,
           "captured_losses": cap_l, "eager_losses": eag_l,
           "state": snapshot_diff(cap_s, eag_s)}
    want_n = ({"lovasz_histograms": GRAPH_AB_STEPS, "lovasz_lookup": GRAPH_AB_STEPS}
              if lovasz else {})
    if cap_n != want_n or eag_n != want_n:
        raise AssertionError(f"graphs: {label} launches {cap_n} captured, {eag_n} eager, "
                             f"want {want_n}")
    if lovasz:
        row["max_loss_diff"] = max(abs(a - b) for a, b in zip(cap_l, eag_l))
        loss_ok = row["max_loss_diff"] <= LOVASZ_VALUE_ATOL
    else:
        loss_ok = cap_l == eag_l
    if row["state"]["n_differ"] or not loss_ok or replays != GRAPH_AB_STEPS - 1:
        raise AssertionError(f"graphs: captured and eager {label} steps differ: {row}")
    return row


def train_timing(flags, k: int, eager: bool) -> dict:
    """Host-clock p50 of one step (a dispatch over k) and its stages,
    synchronized apart: the host batch, the upload, and the device step
    (augment, forward, loss, backward, update; with k > 1 the stack too)."""
    tr = graph_trainer(flags + ([f"--train.steps_per_dispatch={k}"] if k > 1 else []))
    pipe, bs = tr.pipeline, tr.cfg.train.batch_size
    st = {"host_batch": [], "upload": [], "device_step": [], "step": []}
    with graphs.eager() if eager else contextlib.nullcontext():
        for _ in range(GRAPH_TIMED + 3):
            t0 = time.perf_counter()
            host = [pipe._assemble(pipe.sampler.sample(bs)) for _ in range(k)]
            t1 = time.perf_counter()
            dev = [pipe._put(h) for h in host]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            dispatch(tr, dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for key, dt in zip(st, (t1 - t0, t2 - t1, t3 - t2, t3 - t0)):
                st[key].append(dt * 1e3 / k)
    del tr
    return {f"{key}_ms": float(np.median(v[3:])) for key, v in st.items()}


def eval_ab() -> dict:
    """The Trainer's evaluate() with the flip+ms TTA ladder over a val split
    whose last batch is padded: captured equal to eager, metric for metric."""
    tr = graph_trainer(["--data.val_split=0.05", "--train.eval_tta=flip+ms"])
    n_val = tr.combined.val_size
    captured = tr.evaluate()
    with graphs.eager():
        eager = tr.evaluate()
    replays = tr.eval_step.replays()
    del tr
    if captured != eager or n_val % BATCH == 0 or replays != -(-n_val // BATCH) - 1:
        raise AssertionError(f"graphs: eval captured {captured} eager {eager}, "
                             f"{n_val} samples, {replays} replays")
    return {"val_samples": n_val, "replays": replays, "val_miou": captured["val_miou"],
            "equal": True}


# each path kernel's wrapper launches one of these device kernels once per
# call (and the other kernel of its source, where it has one, beside it)
DEVICE_KERNELS = {"argmax_colorize": "argmax_colorize_kernel",
                  "fused_upsample_concat_conv": "upconcat_mma_kernel",
                  "lovasz_histograms": "hist_partial", "lovasz_lookup": "lookup_kernel"}


def device_time(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def on_device(e) -> bool:
    """The device's own events (kernels, copies, fills), not the host ops
    that launched them."""
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def device_counts(events, wrappers) -> dict:
    """How often the device ran each wrapper's kernel, from torch.profiler's
    averaged events (a kernel inside a graph counts at every replay)."""
    out = {}
    for w in wrappers:
        name = re.compile(rf"(^|[\s:]){DEVICE_KERNELS[w]}[<(]")
        out[w] = sum(e.count for e in events if on_device(e) and name.search(e.key))
    return out


def check_counted(counts: dict, events, wrappers, what: str) -> dict:
    """The launch counters against the device's kernel counts."""
    seen = device_counts(events, wrappers)
    mine = {w: counts.get(w, 0) for w in wrappers}
    if seen != mine or not all(seen.values()):
        raise AssertionError(f"graphs: {what}: launch counters {mine}, the device ran {seen}")
    return seen


def train_profile() -> dict:
    """A PROFILE_STEPS-step run through Trainer.train() with profile_dir:
    the device operations that take most of its time, and their sum."""
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as prof_dir:
        tr = graph_trainer(["--train.loss=lovasz", f"--train.profile_dir={prof_dir}",
                            f"--train.steps_per_epoch={PROFILE_STEPS}"])
        kernels.reset_launches()
        tr.train()
        counts = dict(kernels.launches)
        traces = sorted(p.name for p in Path(prof_dir).glob("*.trace.json"))
        events = tr.profiler.key_averages()
    rows = sorted((e for e in events if on_device(e) and device_time(e) > 0),
                  key=device_time, reverse=True)
    total_ms = sum(device_time(e) for e in rows) / 1e3
    if not traces or total_ms <= 0:
        raise AssertionError(f"profile_dir wrote {traces}, device time {total_ms} ms")
    seen = check_counted(counts, events, ("lovasz_histograms", "lovasz_lookup"),
                         f"{PROFILE_STEPS}-step profile_dir run")
    if set(seen.values()) != {PROFILE_STEPS}:
        raise AssertionError(f"graphs: {PROFILE_STEPS} profiled steps ran {seen}")
    return {"steps": tr.step, "traces": traces, "device_ms_total": total_ms,
            "device_ms_per_step": total_ms / tr.step,
            "device_kernel_counts": seen,
            "top": [{"name": e.key[:90], "calls": e.count, "device_ms": device_time(e) / 1e3,
                     "share": device_time(e) / 1e3 / total_ms} for e in rows[:12]],
            "note": "the first step runs eagerly (warm-up) before the capture; "
                    "self device time, summed over the run"}


def flops(pth: Path, frames) -> dict:
    """FLOPs (aten convs and products, FlopCounterMode) of one eager train
    step of the slice's configuration and of one served forward (the plain
    decoder: the kernel route's decoder is not an aten op), and the time
    the card would take for them at the fp32 peak (TF32 off)."""
    from torch.utils.flop_counter import FlopCounterMode

    tr = graph_trainer(["--train.loss=lovasz"])
    batch = draw_batches(tr, 1)[0]
    with graphs.eager(), FlopCounterMode(display=False) as fc:
        tr.train_step(*batch)
    step = fc.get_total_flops()
    del tr
    p = flagship(pth, PLAIN_FLAGS)
    with FlopCounterMode(display=False) as fc, torch.inference_mode():
        p.model(model_input(p, frames[0]))
    fwd = fc.get_total_flops()
    return {"train_step_gflop": step / 1e9, "train_step_bound_ms": bound_ms(0, step)[0],
            "serve_forward_gflop": fwd / 1e9, "serve_forward_bound_ms": bound_ms(0, fwd)[0],
            "peak": "fp32 67 TFLOP/s (TF32 off)"}


def same_outputs(a, b) -> bool:
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def serve_graphs(pth: Path, frames) -> dict:
    """Every serve_ab route and every HTTP bucket: captured class maps (and
    colours) bit-equal to eager ones; the kernel route's launches counted
    through replays and held against the device's kernel counts; the
    Predictor's graph cache; eager against captured device stage and
    frames/s."""
    from torch.profiler import ProfilerActivity, profile

    from tpuseg_torch.tools import serve

    out = {"routes": {}, "buckets": {}}
    routes = serve_ab_routes(pth)
    for label, p in routes.items():
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = [p(f) for f in frames]
            torch.cuda.synchronize()
        counts = dict(kernels.launches)
        with graphs.eager():
            want = [p(f) for f in frames]
        if not all(same_outputs(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"graphs: route {label} captured differs from eager")
        replays = p._device_forward.replays()
        if replays != len(frames) - 1:
            raise AssertionError(f"graphs: route {label} replayed {replays} times")
        if label.startswith("kernels") and (
                counts["argmax_colorize"] != len(frames)
                or counts["fused_upsample_concat_conv"] != 4 * len(frames)):
            raise AssertionError(f"graphs: {label} launches {counts} over {len(frames)} calls")
        row = {"bit_equal": True, "replays": replays, "launches": counts}
        if label.startswith("kernels"):
            row["device_kernel_counts"] = check_counted(
                counts, prof.key_averages(), ("argmax_colorize", "fused_upsample_concat_conv"),
                f"route {label}")
        out["routes"][label] = row
    args = serve.parse_args(["--port", "0", "--checkpoint", str(pth), "--max_batch", "8"])
    p = serve.build_predictor(args)
    small = [p._maybe_host_resize(np.ascontiguousarray(f)) for f in frames]
    b = 1
    while b <= 8:
        got = [p(f[:b]) for f in small]
        with graphs.eager():
            want = [p(f[:b]) for f in small]
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"graphs: HTTP bucket {b} captured differs from eager")
        out["buckets"][str(b)] = {"bit_equal": True}
        b *= 2
    out["http_predictor_replays"] = p._device_forward.replays()
    out["graph_cache"] = graph_cache(pth)
    # eager against captured, in turns: eager, captured, captured, eager
    timing = {}
    for label in ("kernels_decoder_colorize_on_upscale_host",
                  "plain_decoder_colorize_off_upscale_host"):
        p, rows = routes[label], {"eager": [], "captured": []}
        for mode in ("eager", "captured", "captured", "eager"):
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                fps, p50 = timed(p, frames)
                rows[mode].append({"frames_per_s": fps, "p50_batch_ms": p50,
                                   "device_ms": stages(p, frames)["device"]})
        timing[label] = rows
    out["timing"] = timing
    return out


def reserved_after_release() -> int:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def graph_cache(pth: Path) -> dict:
    """The Predictor's graph cache at 2 * MAX_GRAPHS frame sizes, one frame
    each: it keeps MAX_GRAPHS keys and the device memory of as many (an
    unbounded cache would hold twice that), and a dropped key is captured
    again and answers as eager."""
    p = flagship(pth, KERNEL_FLAGS, colorize_on_device=True)
    cap = p.MAX_GRAPHS
    rng = np.random.RandomState(SEED)
    sizes = [(FRAME_HW[0] + 8 * i, FRAME_HW[1]) for i in range(2 * cap)]
    frames = [rng.randint(0, 256, (1, *hw, 3), np.uint8) for hw in sizes]
    base = reserved_after_release()
    first = [p(f) for f in frames[:cap]]
    held = reserved_after_release() - base
    rest = [p(f) for f in frames[cap:]]
    after = reserved_after_release() - base
    again = p(frames[0])
    with graphs.eager():
        want = [p(f) for f in frames]
    row = {"max_graphs": cap, "frame_sizes": len(sizes), "kept": len(p._device_forward.entries),
           "captures": p._device_forward.captures,
           "reserved_mib_after_max_graphs": held / 2**20,
           "reserved_mib_after_twice_as_many": after / 2**20}
    if row["kept"] != cap or row["captures"] != 2 * cap + 1 or not after < 1.5 * held or \
            not all(same_outputs(g, w) for g, w in zip(first + rest + [again], want + want[:1])):
        raise AssertionError(f"graphs: the Predictor's graph cache: {row}")
    del p
    return row


def phase_graphs(pth: Path, frames) -> None:
    """The captured steps: train steps (the slice's and an options
    configuration), K steps per dispatch, the served forwards; bit-equal
    to eager; then eager against captured times and a profiled run."""
    out = {"phase": "graphs",
           "register_generator_state": hasattr(torch.cuda.CUDAGraph,
                                               "register_generator_state")}
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out["train_lovasz"] = train_ab(["--train.loss=lovasz"], "lovasz", lovasz=True)
            out["train_options"] = train_ab(GRAPH_OPTIONS, "options", lovasz=False)
            out["train_remat"] = train_ab(["--train.loss=lovasz", "--train.remat=true"],
                                          "remat", lovasz=True)
            out["eval"] = eval_ab()
            steps = 2 * GRAPH_K
            multi_l, multi_s, multi_r, multi_n = train_run(["--train.loss=lovasz"], steps,
                                                           False, GRAPH_K)
            single_l, single_s, _, single_n = train_run(["--train.loss=lovasz"], steps, False)
            multi = {"k": GRAPH_K, "steps": steps, "replays": multi_r,
                     "launches_multi": multi_n, "launches_single": single_n,
                     "state": snapshot_diff(multi_s, single_s),
                     "max_loss_diff": max(abs(a - b) for a, b in zip(multi_l, single_l))}
            if multi["state"]["n_differ"] or multi["max_loss_diff"] > LOVASZ_VALUE_ATOL \
                    or multi_r != 1 or multi_n != single_n or \
                    multi_n.get("lovasz_histograms") != steps:
                raise AssertionError(f"graphs: {GRAPH_K} steps per dispatch differ from "
                                     f"single steps: {multi}")
            out["steps_per_dispatch"] = multi
            out["serve"] = serve_graphs(pth, frames)
        out["nondeterministic_ops"] = sorted({str(w.message).split(" ")[0] for w in caught
                                              if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    flags = ["--train.loss=lovasz"]
    timing = {}
    for k in (1, GRAPH_K):
        rows = {"eager": [], "captured": []}
        for mode in ("eager", "captured", "captured", "eager"):
            rows[mode].append(train_timing(flags, k, mode == "eager"))
        timing[f"steps_per_dispatch_{k}"] = rows
    out["train_timing"] = timing
    out["train_profile"] = train_profile()
    out["flops"] = flops(pth, frames)
    emit(out)


# the export phase: calibration batches and the eval_quantized run
EXPORT_CALIB_BATCHES, EVAL_QUANT_SAMPLES = 8, 64
ARTIFACT_RTOL = 1e-5
ARTIFACT_AGREE, BN_FOLDED_AGREE = 0.999, 0.999
EXPORT_DEVICE = "cuda"


def export_input(frames: np.ndarray) -> torch.Tensor:
    """The served flagship's NCHW model input for one batch of frames."""
    x = torch.from_numpy(frames).to(EXPORT_DEVICE).float()
    return normalize_images(resize_bilinear(x, *MODEL_HW)).permute(0, 3, 1, 2)


def export_predictor(checkpoint: str = "", **kw) -> Predictor:
    return Predictor(load_config(PLAIN_FLAGS).model, checkpoint=checkpoint,
                     input_hw=MODEL_HW, batch_size=BATCH, device=EXPORT_DEVICE, **kw)


def run_tool(main_fn, argv) -> tuple:
    """(rc, stdout) of an entry point's ``main(argv)`` run in this process."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue()


def int8_exactness(model, x: torch.Tensor) -> dict:
    """Every calibrated conv's int32 sums on the card (its card route) held
    bit-equal to the plain float64 version, on the conv's own int8 input
    in the int8 forward of ``x``; and each conv timed, int8 route (quantize,
    int8 conv, rescale) against cuDNN's fp32 conv of the same shapes."""
    from tpuseg_torch.models.blocks import Conv2d
    from tpuseg_torch.ops.int8_conv import card_route, int8_conv, int8_conv_plain, quantize_act

    convs = {n: m for n, m in model.named_modules() if isinstance(m, Conv2d) and m.int8}
    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, n=n: inputs.__setitem__(n, args[0].detach().clone()))
        for n, m in convs.items()]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    rows, n_terms, total = {}, [], {"int8_ms": 0.0, "fp32_ms": 0.0}
    for name, m in convs.items():
        q, xin = m.int8, inputs[name]
        args = (m.stride, m.padding, m.dilation, m.groups)
        xq = quantize_act(xin, q["act_scale"])
        got = int8_conv(xq, q["kernel_q"], *args)
        # the plain version on the host CPU, on two of the batch's images
        want = int8_conv_plain(xq[:2].cpu(), q["kernel_q"].cpu(), *args)
        if not torch.equal(got[:2].cpu(), want):
            raise AssertionError(f"export: int8 conv {name} differs from its plain version")
        k = q["kernel_q"][0].numel()
        n_terms.append(k)
        route = card_route(q["kernel_q"].shape, m.groups)
        w32 = m.weight.detach()
        int8_ms = device_ms(m, [(xin,)], replays=10)
        fp32_ms = device_ms(lambda t, w=w32, a=args: F.conv2d(t, w, None, *a), [(xin,)],
                            replays=10)
        total["int8_ms"] += int8_ms
        total["fp32_ms"] += fp32_ms
        r = rows.setdefault(route, {"convs": 0, "int8_ms": 0.0, "fp32_cudnn_ms": 0.0})
        r["convs"] += 1
        r["int8_ms"] += int8_ms
        r["fp32_cudnn_ms"] += fp32_ms
    return {"convs_bit_equal": len(convs), "largest_K": max(n_terms),
            "routes": rows, "convs_int8_ms": total["int8_ms"],
            "convs_fp32_cudnn_ms": total["fp32_ms"],
            "note": "each conv timed alone on its own input (CUDA events over graph "
                    "replays); int8 = quantize + int8 conv + rescale + bias"}


def served_in_turns(preds: dict, frames) -> dict:
    """Frames/s, p50 and the device stage of each Predictor, two rounds in
    turns (forward order, then reverse)."""
    rows = {k: [] for k in preds}
    for order in (list(preds), list(preds)[::-1]):
        for label in order:
            fps, p50 = timed(preds[label], frames)
            rows[label].append({"frames_per_s": fps, "p50_batch_ms": p50,
                                "device_ms": stages(preds[label], frames)["device"]})
    return rows


def export_int8(pth: Path, tmp: Path, frames) -> dict:
    """Calibrate on the card through ``tpuseg_torch.convert``, hold every
    conv's int32 sums to the plain version, serve the int8 checkpoint."""
    from tpuseg_torch import convert
    from tpuseg_torch.export.int8_full import bind_quant, calibrate, count_quantized_convs

    out = {}
    # the calibration convert runs, timed on its own
    model = build_model(load_config(PLAIN_FLAGS).model)
    model.to(EXPORT_DEVICE, memory_format=torch.channels_last)
    sd = torch.load(pth, weights_only=True)
    calib = convert.synthetic_batches(EXPORT_CALIB_BATCHES, BATCH, MODEL_HW[1], MODEL_HW[0],
                                      convert.CALIB_SEED, EXPORT_DEVICE)
    t0 = time.perf_counter()
    quant = calibrate(model, sd, calib)
    torch.cuda.synchronize()
    out["calibrate_s"] = time.perf_counter() - t0
    out["calibrated_convs"] = count_quantized_convs(quant)
    bind_quant(model, quant).eval()
    x = export_input(frames[0])
    out["exactness"] = int8_exactness(model, x)
    fp32 = build_model(load_config(PLAIN_FLAGS).model)
    fp32.load_state_dict(sd)
    fp32.to(EXPORT_DEVICE, memory_format=torch.channels_last).eval()
    sets = [(export_input(f),) for f in frames]
    with torch.inference_mode():
        out["forward_device_ms"] = {
            "int8": [device_ms(model, sets), device_ms(model, sets)],
            "fp32_plain_decoder": [device_ms(fp32, sets), device_ms(fp32, sets)]}
    del model, fp32

    ck = str(tmp / "int8")
    rc, text = run_tool(convert.main, [f"--export.checkpoint={pth}", f"--export.output={ck}",
                                       "--export.format=quantized"] + PLAIN_FLAGS)
    # convert writes the checkpoint, then guards int8 against fp32 at 0.9 of
    # the pixels: on seeded weights int8 noise outgrows the logits' margins
    # in both packages (PERF.md §6), so its verdict is recorded and the
    # port's int8 route is held to its plain version below
    if "mask agreement" not in text or (rc != 0 and "diverge from fp32" not in text):
        raise AssertionError(f"export: convert --export.format=quantized rc {rc}: {text}")
    out["convert_quantized"] = {"rc": rc, "lines": text.strip().splitlines(),
                                "note": "the 0.9 guard on seeded weights is the tool's "
                                        "finding, not a check of the port"}
    int8 = export_predictor(ck, colorize_on_device=True)
    fp32 = export_predictor(str(pth), colorize_on_device=True)
    if not int8.int8 or fp32.int8:
        raise AssertionError("export: the int8 checkpoint is not served in int8")
    kernels.reset_launches()
    got = [int8(f) for f in frames]
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    want_counts = {k: 0 for k in counts}
    want_counts["argmax_colorize"] = len(frames)
    if counts != want_counts:
        raise AssertionError(f"export: int8 serving launches {counts}, expected {want_counts}")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with graphs.eager():
            eager = [int8(f) for f in frames]
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if not all(same_outputs(g, e) for g, e in zip(got, eager)):
        raise AssertionError("export: captured int8 class maps differ from eager ones")
    # the whole int8 forward with every conv on its card route against the
    # same forward with every conv on the plain version (float64 convs, on
    # the card too): the convs are exact, so the logits are bit-equal
    from tpuseg_torch.models import blocks
    from tpuseg_torch.ops.int8_conv import int8_conv_plain

    def plain(*args):
        # in the card routes' channels-last layout: BatchNorm on the card
        # rounds an ulp apart between layouts, which the int8 grids amplify
        return int8_conv_plain(*args).contiguous(memory_format=torch.channels_last)

    x = export_input(frames[0])
    with torch.inference_mode():
        card_logits = int8.model(x)
        route = blocks.int8_conv
        blocks.int8_conv = plain
        try:
            plain_logits = int8.model(x)
        finally:
            blocks.int8_conv = route
    if not torch.equal(card_logits, plain_logits):
        raise AssertionError("export: the int8 forward on the card routes differs from the "
                             "same forward on the plain int8 convs")
    agree, distinct = check_served(got, frames, lambda f: fp32(f)[0], "int8")
    out["serve"] = {"launches": counts, "captured_equals_eager": True,
                    "replays": int8._device_forward.replays(),
                    "logits_bit_equal_to_plain_int8_convs": True,
                    "agreement_with_fp32": agree, "classes_seen": sorted(distinct),
                    "timing": served_in_turns({"int8": int8, "fp32_plain_decoder": fp32},
                                              frames)}
    return out


def convert_verdict(argv) -> dict:
    """rc and lines of ``tpuseg_torch.convert`` run in-process; it must
    write its artifact and reach its round-trip check (rc 1 only from that
    check's verdict)."""
    from tpuseg_torch import convert

    rc, text = run_tool(convert.main, argv)
    if "Round-trip check" not in text or (rc != 0 and "diverges from source" not in text):
        raise AssertionError(f"export: convert {argv} rc {rc}: {text}")
    return {"rc": rc, "lines": text.strip().splitlines()}


def export_artifact(pth: Path, tmp: Path, frames) -> dict:
    """``convert --export.format=stablehlo`` (a torch.export program, a
    symbolic batch) with BatchNorm unfolded, served through
    ``Predictor(artifact=)`` against the live model; the fp16 artifact and
    its convert verdict."""
    from tpuseg_torch.export.torch_export import load_exported

    out = {}
    path = str(tmp / "model.pt2")
    t0 = time.perf_counter()
    out["convert_unfolded"] = convert_verdict(
        [f"--export.checkpoint={pth}", f"--export.output={path}", "--export.fold_bn=false"]
        + PLAIN_FLAGS)
    out["convert_s"] = time.perf_counter() - t0
    if out["convert_unfolded"]["rc"] != 0:
        raise AssertionError(f"export: the unfolded artifact failed convert's check: {out}")
    live = export_predictor(str(pth), colorize_on_device=True)
    call = load_exported(path, EXPORT_DEVICE)
    x = export_input(frames[0])
    rels = {}
    for b in (2, BATCH):
        with torch.inference_mode():
            want = live.model(x[:b]).permute(0, 2, 3, 1)
            got = call(x[:b].permute(0, 2, 3, 1).contiguous())
        rels[str(b)] = float((got - want).abs().max() / want.abs().max())
    if max(rels.values()) >= ARTIFACT_RTOL:
        raise AssertionError(f"export: artifact logits off by rel {rels}")
    out["logits_rel_by_batch"] = rels
    art = export_predictor(artifact=path, colorize_on_device=True)
    kernels.reset_launches()
    got = [art(f) for f in frames]
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    if counts["argmax_colorize"] != len(frames) or sum(counts.values()) != len(frames):
        raise AssertionError(f"export: artifact serving launches {counts}")
    agree, distinct = check_served(got, frames, lambda f: live(f)[0], "artifact")
    if min(agree) < ARTIFACT_AGREE:
        raise AssertionError(f"export: artifact agreement {agree}")
    out["serve"] = {"launches": counts, "agreement_with_live": agree,
                    "classes_seen": sorted(distinct),
                    "timing": served_in_turns({"artifact": art, "live_plain_decoder": live},
                                              frames)}
    # fp16 weights move the logits; the seeded weights amplify that past
    # convert's 1e-2 in both packages (PERF.md §6): recorded
    path16 = str(tmp / "model16.pt2")
    out["convert_fp16"] = convert_verdict(
        [f"--export.checkpoint={pth}", f"--export.output={path16}", "--export.dtype=float16"]
        + PLAIN_FLAGS)
    stored = {str(t.dtype) for t in torch.export.load(path16).state_dict.values()}
    if "torch.float16" not in stored:
        raise AssertionError(f"export: the fp16 artifact stores {stored}")
    out["fp16"] = {"stores": sorted(stored), "bytes": os.path.getsize(path16),
                   "fp32_bytes": os.path.getsize(path)}
    return out


def export_onnx_check(pth: Path, tmp: Path, frames) -> dict:
    """``convert --export.format=onnx`` (its verdict recorded), then
    ``run_model`` on the card against the live model: the structural check
    empty and the class maps on 99.9% of the pixels; the logits' gap
    recorded (the interpreter's BatchNorm rounds apart from cuDNN's, which
    the seeded weights amplify past convert's 1e-5 in both packages:
    PERF.md §6)."""
    from tpuseg_torch.export.onnx_run import check_model, run_model

    path = str(tmp / "model.onnx")
    verdict = convert_verdict([f"--export.checkpoint={pth}", f"--export.output={path}",
                               "--export.format=onnx"] + PLAIN_FLAGS)
    data = Path(path).read_bytes()
    problems = check_model(data)
    live = export_predictor(str(pth))
    x = export_input(frames[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run_model(data, {"input": x.contiguous()})["output"]
    run_s = time.perf_counter() - t0
    with torch.inference_mode():
        want = live.model(x).cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    agree = float((got.argmax(1) == want.argmax(1)).mean())
    if problems or agree < ARTIFACT_AGREE:
        raise AssertionError(f"export: onnx problems {problems}, maps agree on {agree}, "
                             f"logits rel {rel}")
    return {"convert": verdict, "bytes": len(data), "check_model": problems,
            "run_model_rel": rel, "run_model_agreement": agree, "run_model_s": run_s,
            "run_model_device": str(x.device)}


def export_eval_quantized(pth: Path) -> dict:
    """``tpuseg_torch.tools.eval_quantized`` on 64 synthetic scenes."""
    from tpuseg_torch.tools import eval_quantized

    t0 = time.perf_counter()
    rc, text = run_tool(eval_quantized.main, [
        "--checkpoint", str(pth), "--samples", str(EVAL_QUANT_SAMPLES), "--batch", str(BATCH),
        "--height", str(MODEL_HW[0]), "--width", str(MODEL_HW[1])])
    wall = time.perf_counter() - t0
    result = json.loads(text[text.index("{"): text.rindex("}") + 1])
    variants = ["fp32", "bn_folded", "int8_weights", "fp16_weights", "int8_full"]
    if list(result) != variants or result["bn_folded"]["mask_agreement"] < BN_FOLDED_AGREE:
        raise AssertionError(f"export: eval_quantized gave {result}")
    return {"rc": rc, "result": result, "verdict": text.strip().splitlines()[-1],
            "wall_s": wall, "note": "seeded weights on synthetic scenes: the 1-point verdict "
                                    "is the tool's finding, not a check of the port"}


def export_tf(pth: Path, tmp: Path) -> dict:
    """``convert --export.format=savedmodel`` on this host: it needs
    TensorFlow, which the card's host does not have, so it must exit 1
    naming TensorFlow and write nothing (where TF imports: exit 0 with its
    round trip valid)."""
    from tpuseg_torch import convert

    has_tf = importlib.util.find_spec("tensorflow") is not None
    path = tmp / "savedmodel"
    rc, text = run_tool(convert.main, [f"--export.checkpoint={pth}",
                                       f"--export.output={path}",
                                       "--export.format=savedmodel"] + PLAIN_FLAGS)
    ok = (rc == 0 and "Export is valid!" in text) if has_tf else \
        (rc == 1 and "TensorFlow" in text and not path.exists())
    if not ok:
        raise AssertionError(f"export: savedmodel with TensorFlow {has_tf}: rc {rc}: {text}")
    return {"tensorflow": has_tf, "rc": rc, "lines": text.strip().splitlines()}


def phase_export(pth: Path, frames) -> dict:
    """Slice 12: int8 calibration and serving, the torch.export artifact,
    ONNX and eval_quantized, on the flagship's seeded weights."""
    out, walls = {"phase": "export"}, {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for part, run in (("int8", lambda: export_int8(pth, Path(tmp), frames)),
                          ("artifact", lambda: export_artifact(pth, Path(tmp), frames)),
                          ("onnx", lambda: export_onnx_check(pth, Path(tmp), frames)),
                          ("eval_quantized", lambda: export_eval_quantized(pth)),
                          ("savedmodel", lambda: export_tf(pth, Path(tmp)))):
            t0 = time.perf_counter()
            out[part] = run()
            walls[part] = time.perf_counter() - t0
    out["wall_s"] = walls
    out["launches"] = {k: out["int8"]["serve"]["launches"][k]
                       + out["artifact"]["serve"]["launches"][k] for k in kernels.launches}
    emit(out)
    return out


# the ablate phase: each tool at its defaults (ablate_forward: batch 64,
# 512x512, chain 16, bf16; ablate_train: batch 64, 256x128, chain 8) and
# one other setting (the materialized decoder; fp32)
ABLATE_FORWARD = {"batch": 64, "size": 512, "chain": 16}
ABLATE_TRAIN = {"batch": 64, "height": 128, "width": 256, "chain": 8}
ABLATE_FULL_CALLS = 3
ABLATE_DEVICE = "cuda"


def stage_deltas(rows: dict) -> dict:
    """Each row's time less the row before it (the nested prefixes)."""
    names = list(rows)
    return {f"{b} - {a}": rows[b] - rows[a] for a, b in zip(names, names[1:])}


@contextlib.contextmanager
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def captured_vs_eager(fn, args, name: str) -> bool:
    """A fresh capture of ``fn`` (a row that leaves the model as it was),
    replayed once, bit-equal to ``fn`` under ``graphs.eager()``, both under
    deterministic algorithms."""
    with deterministic():
        step = graphs.Captured(fn, name)
        step(*args)
        got = step(*args).clone()
        with graphs.eager():
            want = fn(*args)
    return bool(torch.equal(got, want))


def ablate_full_vs_eager(dtype: str) -> bool:
    """The ``full`` row (the real train step, which moves the model): two
    models from one seed, ABLATE_FULL_CALLS steps captured against as many
    under ``graphs.eager()``, under deterministic algorithms: every loss and
    every final parameter and BatchNorm statistic bit-equal."""
    from tpuseg_torch.tools import ablate_train

    a = ABLATE_TRAIN
    runs = []
    with deterministic():
        for eager in (False, True):
            model, x, y = ablate_train.build(a["batch"], a["height"], a["width"], dtype,
                                             ABLATE_DEVICE)
            step = ablate_train.full_step(model)
            with graphs.eager() if eager else contextlib.nullcontext():
                losses = [step(x, y)["loss"].clone() for _ in range(ABLATE_FULL_CALLS)]
            runs.append((losses, {k: t.clone() for k, t in model.state_dict().items()}))
            del model, step
    (la, sa), (lb, sb) = runs
    return (all(torch.equal(p, q) for p, q in zip(la, lb))
            and all(torch.equal(sa[k], sb[k]) for k in sa))


def phase_ablate() -> dict:
    """The port's per-stage device times: ``tpuseg_torch.tools.ablate_forward``
    at its defaults and with the materialized decoder, ``ablate_train`` at
    its defaults (bf16) and in fp32; each row a CUDA graph replayed between
    CUDA events, and each row's captured value bit-equal to the same prefix
    run eager (see captured_vs_eager, ablate_full_vs_eager)."""
    from tpuseg_torch.tools import ablate_forward, ablate_train

    out = {"phase": "ablate", "forward": {}, "train": {}}
    f = ABLATE_FORWARD
    model, x = ablate_forward.build(f["batch"], f["size"], ABLATE_DEVICE)
    for label, subpixel in (("subpixel", True), ("materialized", False)):
        t0 = time.perf_counter()
        rows = ablate_forward.ablate(model, x, f["chain"], subpixel)
        with torch.no_grad():
            equal = {s: captured_vs_eager(ablate_forward.prefix(model, s, subpixel), (x,),
                                          f"ablate_check_{s}")
                     for s in ablate_forward.STAGES}
        ms = {s: r[0] for s, r in rows.items()}
        out["forward"][label] = {
            "ms_per_iter": ms, "deltas_ms": stage_deltas(ms),
            "images_per_s": {s: f["batch"] / (t / 1e3) for s, t in ms.items()},
            "values": {s: r[1] for s, r in rows.items()},
            "captured_equals_eager": equal, "wall_s": time.perf_counter() - t0}
    out["forward"]["config"] = {**f, "dtype": "bfloat16"}
    del model, x
    a = ABLATE_TRAIN
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        model, x, y = ablate_train.build(a["batch"], a["height"], a["width"], dtype,
                                         ABLATE_DEVICE)
        rows = ablate_train.ablate(model, x, y, a["chain"])
        del model
        # a fresh model: ``full`` moved that one
        model, x, y = ablate_train.build(a["batch"], a["height"], a["width"], dtype,
                                         ABLATE_DEVICE)
        equal = {r: captured_vs_eager(ablate_train.row_fn(model, r), (x, y), f"ablate_check_{r}")
                 for r in ablate_train.ROWS}
        del model
        equal["full"] = ablate_full_vs_eager(dtype)
        ms = {r: v[0] for r, v in rows.items()}
        out["train"][dtype] = {
            "ms_per_iter": ms, "deltas_ms": stage_deltas(ms),
            "images_per_s": {r: a["batch"] / (t / 1e3) for r, t in ms.items()},
            "values": {r: v[1] for r, v in rows.items()},
            "captured_equals_eager": equal, "wall_s": time.perf_counter() - t0}
    out["train"]["config"] = dict(a)
    for part in ("forward", "train"):
        for label, r in out[part].items():
            if label == "config":
                continue
            if not all(r["captured_equals_eager"].values()) \
                    or not all(math.isfinite(v) for v in r["values"].values()):
                raise AssertionError(f"ablate: {part} {label}: {r}")
    torch.cuda.empty_cache()
    emit(out)
    return out


SWEEP_GRID = [["ce", []], ["lovasz", ["--train.loss=lovasz"]]]
SWEEP_ARGV = ["--epochs", "1"]


def phase_sweep() -> dict:
    """``tpuseg_torch.tools.convergence_sweep`` on a two-row grid (ce and
    lovasz) at --epochs 1 on the protocol's base config (bf16, batch 64,
    2276 synthetic scenes, 8 steps a dispatch, a 10% val split): both
    records ok with a finite val mIoU, the Lovász kernels launched once a
    step of the lovasz run and never in the ce run; then the same command
    again, which skips both runs and appends nothing. No post-eval: it
    reads an on-disk set, which needs cv2. First the two Lovász kernels
    are held against their plain versions at the protocol's [C, B*H*W],
    more pixels a block than any other phase gives them."""
    from tpuseg_torch.tools import convergence_sweep

    base = load_config(convergence_sweep.protocol_flags("check", 1, str(_build.BUILD_DIR)))
    p = base.train.batch_size * base.data.height * base.data.width
    out = {"phase": "sweep", "grid": SWEEP_GRID,
           "lovasz_shape": lovasz_shape_check(p, 800, "sweep")}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        runs = Path(tmp) / "runs.json"
        runs.write_text(json.dumps(SWEEP_GRID))
        sweep = Path(tmp) / "sweep"
        argv = ["--runs", str(runs), "--out", str(sweep), *SWEEP_ARGV]
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, _ = run_tool(convergence_sweep.main, argv)
        out["wall_s"] = time.perf_counter() - t0
        out["launches"] = dict(kernels.launches)
        records = [json.loads(line) for line in (sweep / "sweep.jsonl").open()]
        hist = {name: convergence_sweep.last_epoch(str(sweep / name / "history.jsonl"))
                for name, _ in SWEEP_GRID}
        t0 = time.perf_counter()
        rc2, text2 = run_tool(convergence_sweep.main, argv)
        out["rerun_s"] = time.perf_counter() - t0
        n_after = sum(1 for _ in (sweep / "sweep.jsonl").open())
    steps = {name: h["step"] for name, h in hist.items()}
    out.update(records=records, steps=steps,
               train_imgs_per_s={name: h["imgs_per_sec"] for name, h in hist.items()},
               rerun_skipped=text2.count("already complete, skip"))
    lovasz = {"lovasz_histograms": steps["lovasz"], "lovasz_lookup": steps["lovasz"]}
    if (rc != 0 or rc2 != 0 or [r["name"] for r in records] != [n for n, _ in SWEEP_GRID]
            or not all(r["ok"] and math.isfinite(r["val_miou"] or float("nan"))
                       for r in records)
            or steps["lovasz"] <= 0 or out["launches"] != {**out["launches"], **lovasz}
            or out["rerun_skipped"] != len(SWEEP_GRID) or n_after != len(SWEEP_GRID)):
        raise AssertionError(f"sweep: {out}")
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    has_cv2 = cv2_installed()
    sys.meta_path.insert(0, RefuseCv2())
    if "cv2" in sys.modules:
        raise AssertionError("cv2 was imported before it could be refused")
    # before cuBLAS starts: the train phase's A/B runs deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    info = phase_device(has_cv2)
    phase_build()
    perf = phase_kernels()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        pth = Path(tmp) / "weights.pth"
        seeded_weights(load_config([]), pth)
        pred, frames, serve_counts = phase_serve(pth, info["name"])
        head_counts = phase_head(pred, frames)
        mbconv_counts = phase_mbconv(pred, frames)
        del pred
        phase_families(Path(tmp), frames)
        phase_stem_s2d(pth, frames)
        phase_serve_options(pth, frames)
        phase_serve_ab(pth, frames)
        video_counts = phase_video(pth)
        phase_http(pth, frames)
        phase_graphs(pth, frames)
        export = phase_export(pth, frames)
    train = phase_train(perf)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as packed_dir:
        packed = phase_train_packed(train, packed_dir)
        contact = phase_train_contact(packed_dir)
        bf16 = phase_bf16(perf, train)
        mesh = phase_mesh()
        spatial = phase_spatial(packed_dir)
    phase_ablate()
    sweep = phase_sweep()
    spatial_launches = [r["launches"] for r in spatial["train"]] + \
        spatial["combined"]["launches_per_rank"]
    train_counts = {k: train["launches"][k] + packed["launches"][k]
                    + sum(r["launches"].get(k, 0) for r in mesh["train"])
                    + sum(r.get(k, 0) for r in spatial_launches)
                    + bf16["path_launches"][k] + contact["launches"][k] + sweep["launches"][k]
                    + sum(r.get(k, 0) for r in contact["mesh_launches_per_rank"])
                    for k in train["launches"]}
    # the serving paths: the serve phase's batches, the video phase's and
    # the bf16 phase's
    launches = {"argmax_colorize": serve_counts["argmax_colorize"]
                + video_counts["argmax_colorize"] + bf16["path_launches"]["argmax_colorize"]
                + export["launches"]["argmax_colorize"],
                "upsample2x_argmax": head_counts["upsample2x_argmax"],
                "fused_upsample_concat_conv": serve_counts["fused_upsample_concat_conv"]
                + video_counts["fused_upsample_concat_conv"]
                + bf16["path_launches"]["fused_upsample_concat_conv"],
                "lovasz_histograms": train_counts["lovasz_histograms"],
                "lovasz_lookup": train_counts["lovasz_lookup"],
                # no served or training path runs the block kernel, as no JAX
                # path runs the TPU one: its launches are the mbconv check's
                "fused_inverted_residual": 0}
    dec = perf["fused_upsample_concat_conv"]
    blk = perf["fused_inverted_residual"]
    extra = {"fused_inverted_residual": {
        "path": "check only", "check_launches": mbconv_counts["fused_inverted_residual"],
        "bound_tc_ms": blk["bound_tc_ms"], "bound_tc_route": blk["bound_tc_route"],
        "bound_fp32_ms": blk["bound_fp32_ms"],
        "per_call_ms": [r["ms"] for r in blk["per_call"] if "block" in r]},
        "upsample2x_argmax": {"launch_floor_ms": perf["upsample2x_argmax"]["launch_floor_ms"]},
        "lovasz_histograms": {"mesh_launches_per_rank": [r["launches"]["lovasz_histograms"]
                                                         for r in mesh["train"]]},
        "lovasz_lookup": {"mesh_launches_per_rank": [r["launches"]["lovasz_lookup"]
                                                     for r in mesh["train"]],
                          "make_sharded_lovasz": {
                              "route": mesh["route"],
                              "region_ms_per_rank": [r["ms"]["region"]
                                                     for r in mesh["sharded_lovasz"]],
                              "all_reduce_ms": [r["ms"]["all_reduce"]
                                                for r in mesh["sharded_lovasz"]],
                              "local_ms": [r["ms"]["local"] for r in mesh["sharded_lovasz"]],
                              "bound_ms": mesh["region_bound_ms"]}},
        "fused_upsample_concat_conv": {
            "bound_tc_ms": dec["bound_tc_ms"], "bound_tc_route": dec["bound_tc_route"],
            "bound_fp32_ms": dec["bound_fp32_ms"],
            "per_call_ms": {k: r["ms"] for k, r in dec["per_call"].items()}}}
    for k, r in bf16["kernels"].items():
        extra.setdefault(k, {}).update(
            {f"bf16_{f}": r[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "max_abs_err")})
    extra["fused_upsample_concat_conv"]["bf16_library_bf16_ms"] = \
        bf16["kernels"]["fused_upsample_concat_conv"]["library_bf16_ms"]
    for k in ("lovasz_histograms", "lovasz_lookup"):
        extra[k]["bf16"] = "unchanged: the loss promotes the logits to fp32 first"
        extra[k]["train_contact_launches"] = {
            "qat": contact["qat"]["launches"][k], "distill": contact["distill"]["launches"][k],
            "qat_distill_per_rank": [r[k] for r in contact["mesh_launches_per_rank"]]}
        extra[k]["spatial_launches_per_rank"] = [r.get(k, 0) for r in spatial_launches]
        extra[k]["spatial_slab_check"] = spatial["lovasz_slab"]
        extra[k]["sweep_launches"] = sweep["launches"][k]
        extra[k]["sweep_shape_check"] = sweep["lovasz_shape"]
    extra["lovasz_lookup"]["make_sharded_lovasz"]["spatial_region_ms_per_rank"] = [
        r["lovasz_region_ms"] for r in spatial["train"]]
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": perf[k]["max_abs_err"],
         "ms": perf[k]["ms"], "plain_ms": perf[k]["plain_ms"],
         "bound_ms": perf[k]["bound_ms"], "bound_by": perf[k]["bound_by"],
         "library_ms": perf[k]["library_ms"], **extra.get(k, {})}
        for k in REPLACES]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
