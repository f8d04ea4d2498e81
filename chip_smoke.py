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
6. train   — the full-width mobilenetv2_unet trained through
             ``tpuseg_torch.main`` with --train.loss=lovasz (256 bins, batch
             8, 256x128, Adam 1.5e-4, augment on, synthetic scenes): the
             loss falls, a val mIoU is computed, both Lovász kernels launch
             once per step, a checkpoint round-trips; then steady step
             times, the step's stages, and a 3-step A/B of the kernel loss
             against one built on the plain versions, under deterministic
             algorithms: gradients and parameters bit-equal.

Then the kernels summary line, nvidia-smi's line, and, last, the result
line {"ok": true, "device": {...}}. A kernel's ``launches`` there are its
launches on the serving or training path; fused_inverted_residual runs on
no path, so it shows 0 and, as ``check_launches``, the mbconv phase's. Without a CUDA device, or without the
tpuseg_torch package beside this file, it exits nonzero and prints no
result. fp32 comparisons run with TF32 off for both cuDNN and matmul.
"""

from __future__ import annotations

import json
import math
import os
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
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
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


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
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


def lovasz_planes(seed: int):
    """(errors, fg), each f32 [C, P] contiguous, as one training batch gives
    them: |onehot - softmax| of seeded logits against seeded labels, with
    257 pixels at e = 1.0 exactly on their label's class (and 0 on the
    others) and 43 more at e = 0 on every class."""
    c, p = LOVASZ_SHAPE
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
    is off or a colour is not the palette entry of its class."""
    palette = kernels._pack_palette(COLOR_MAP_BGR)
    agree, distinct = [], set()
    for f, (classes, colors) in zip(frames, outs):
        if classes.shape != (BATCH, *FRAME_HW) or colors.shape != classes.shape:
            raise AssertionError(f"{what}: output shape {classes.shape}")
        if not np.array_equal(colors, palette[classes]):
            raise AssertionError(f"{what}: colours are not the palette of the classes")
        agree.append(float((classes == ref(f)).mean()))
        distinct |= set(np.unique(classes).tolist())
    return agree, distinct


def model_input(pred, frames: np.ndarray) -> torch.Tensor:
    """The Predictor's preprocessed NCHW model input for one batch."""
    x = torch.from_numpy(frames).cuda().float()
    return normalize_images(resize_bilinear(x, *MODEL_HW), pred.normalize_mean,
                            pred.normalize_std).permute(0, 3, 1, 2)


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

    def stages(p):
        """Median ms of each step of Predictor.__call__, synchronized apart."""
        ms = {"upload": [], "device": [], "fetch": [], "host_upscale": []}
        for i in range(TIMED_BATCHES):
            f = frames[i % SERVE_BATCHES]
            t0 = time.perf_counter()
            x = torch.from_numpy(f).to(p.device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cls, packed = p._device_forward(x, p.input_hw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host = [t.cpu().numpy() for t in (cls, packed) if t is not None]
            t3 = time.perf_counter()
            for a in host:
                resize_nearest_host(a, *FRAME_HW)
            t4 = time.perf_counter()
            for k, dt in zip(ms, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                ms[k].append(dt * 1e3)
        return {k: float(np.median(v)) for k, v in ms.items()}

    plain_colorize = Predictor(plain_cfg.model, checkpoint=str(pth), input_hw=MODEL_HW,
                               batch_size=BATCH, colorize_on_device=True)
    rows = {}
    for label, p in (("kernels", pred), ("plain_decoder_colorize", plain_colorize),
                     ("plain_decoder_no_colorize", ref)):
        fps, p50 = timed(p, frames)
        rows[label] = {"frames_per_s": fps, "p50_batch_ms": p50, "stages_ms": stages(p)}
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


def phase_train(perf) -> dict:
    """The slice's training configuration through tpuseg_torch.main."""
    import copy

    from tpuseg_torch.main import main as train_main
    from tpuseg_torch.ops.lovasz import lovasz_binned_plain
    from tpuseg_torch.train.loss import lovasz_errors, make_loss_fn
    from tpuseg_torch.train.train_step import create_optimizer, make_train_step
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
        tr.train_step(*batch, tr.aug_generator)
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
    # bit-equal on both routes, so the first step's gradients and the final
    # parameters must be equal; only the loss values differ (error sums).
    start = copy.deepcopy(tr.model.state_dict())
    batches = [tr.augment(*pipe._put(pipe._assemble(pipe.sampler.sample(
        cfg.train.batch_size))), tr.aug_generator) for _ in range(AB_STEPS)]

    def plain_loss(logits, targets):
        return lovasz_binned_plain(*lovasz_errors(logits, targets))

    def ab_run(loss_fn):
        model = build_model(cfg.model).to("cuda", memory_format=torch.channels_last)
        model.load_state_dict(start)
        ab_step = make_train_step(model, create_optimizer(model, lr=cfg.train.lr),
                                  loss_fn=loss_fn)
        losses, grads = [], None
        for x, y in batches:
            losses.append(float(ab_step(x, y)["loss"]))
            if grads is None:
                grads = {k: p.grad.clone() for k, p in model.named_parameters()}
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
    ab = {"steps": AB_STEPS, "max_loss_diff": loss_diff,
          "max_grad_diff": max_diff(gk, gp), "max_param_diff": max_diff(pk, pp),
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
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    # before cuBLAS starts: the train phase's A/B runs deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    info = phase_device()
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
    train_counts = phase_train(perf)
    launches = {"argmax_colorize": serve_counts["argmax_colorize"],
                "upsample2x_argmax": head_counts["upsample2x_argmax"],
                "fused_upsample_concat_conv": serve_counts["fused_upsample_concat_conv"],
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
        "fused_upsample_concat_conv": {
            "bound_tc_ms": dec["bound_tc_ms"], "bound_tc_route": dec["bound_tc_route"],
            "bound_fp32_ms": dec["bound_fp32_ms"],
            "per_call_ms": {k: r["ms"] for k, r in dec["per_call"].items()}}}
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
