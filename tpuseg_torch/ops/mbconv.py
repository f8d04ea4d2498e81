"""The fused MobileNetV2 inverted-residual block: CUDA kernel, plain version.

The port of ``tpuseg/ops/pallas_mbconv.py``:

========================  ==========================  ============
wrapper (JAX signature)   CUDA source (tpuseg_torch/)  plain version
========================  ==========================  ============
fused_inverted_residual   csrc/mbconv.cu               mbconv_plain
========================  ==========================  ============

One eval-mode block with BatchNorm folded into per-channel affines
(``fold_bn_affine``): expand 1x1 + ReLU6 (absent at expand ratio 1),
depthwise 3x3 at stride 1 or 2 with zero padding + ReLU6, project 1x1, and
the residual. NHWC; x fp32 or bf16 (widened as it is read, the block
computed in fp32, the residual added from the widened x, the output
rounded to x's dtype, as the JAX kernel's ``out_shape`` is ``x.dtype``),
every weight and affine fp32. The output has ``H // stride`` rows and
``W // stride`` columns, as ``mbconv_reference``'s (a torch ``Conv2d`` would
give ``(H + 1) // 2`` for odd H).

No path of the JAX package calls its kernel, and no path of the port calls
this one: the encoder runs its blocks as cuDNN convs, as the JAX encoder
runs them through XLA. ``fold_inverted_residual`` turns a port
``InvertedResidual`` into this function's arguments, so the kernel can be
held against the model's own blocks.

The kernel (``csrc/mbconv.cu`` says more): each CTA takes a tile of
output pixels (8x16; 4x16 or 4x8 for the small images), stages the x patch
once, expands only the patch's pixels inside the image (a pad pixel is a
zero, never computed), and streams the hidden channels through in chunks
of 32: expand and project on the tensor cores, exact to fp32 through
3xTF32 ``mma.sync``, the depthwise 3x3 on the CUDA cores, the next chunk's
weights in flight (bulk copies for long spans, ``cp.async`` for short
ones). Where the tiles are few, the hidden
channels are split over a thread-block cluster of up to 16 CTAs that sum
their partial products in rank order through distributed shared memory
(``mbconv_plan``, the kernel's own rule, asks the occupancy API what the
card runs at once): deterministic, with no scratch in device memory. Bound
by operations on that route, 3 TF32 products per 1x1 term at 495 TFLOP/s
plus the depthwise at 67 TFLOP/s: 0.022 ms for the encoder's 17 blocks at
batch 8 and 256x128 (0.044 ms in exact fp32 on the CUDA cores).

Dispatch goes by the tensor's device, as in ``ops/kernels.py``: a CPU
tensor runs the plain version; a CUDA tensor launches the kernel or raises.
There is no shape fallback: the kernel masks its own ragged edges. Each
launch adds one to ``kernels.launches["fused_inverted_residual"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from tpuseg_torch.ops.kernels import (ACTIVATION_DTYPES, _c_fn, _launch, _on_cuda,
                                      _require_contiguous, launches)


def fold_bn_affine(bn_params: Mapping, bn_stats: Mapping, eps: float = 1e-5):
    """BN eval-mode affine ``y = x * scale + bias`` from flax-named
    ``{"scale", "bias"}`` and ``{"mean", "var"}`` (arrays or tensors)."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    scale = f32(bn_params["scale"]) / torch.sqrt(f32(bn_stats["var"]) + eps)
    return scale, f32(bn_params["bias"]) - f32(bn_stats["mean"]) * scale


def _fold_bn(bn) -> Tuple[torch.Tensor, torch.Tensor]:
    return fold_bn_affine({"scale": bn.weight.detach(), "bias": bn.bias.detach()},
                          {"mean": bn.running_mean, "var": bn.running_var}, bn.eps)


def fold_inverted_residual(block) -> Dict[str, object]:
    """A port ``InvertedResidual`` (eval statistics) -> the keyword
    arguments of ``fused_inverted_residual`` (JAX layouts, contiguous)."""
    layers = list(block.conv)
    out: Dict[str, object] = dict(we=None, se=None, be=None)
    if len(layers) == 4:                      # expand ConvBNAct first
        expand = layers.pop(0)
        conv, bn = expand[0], expand[1]
        out["we"] = conv.weight.detach()[:, :, 0, 0].t().contiguous()
        out["se"], out["be"] = _fold_bn(bn)
    dw, proj, proj_bn = layers
    out["wd"] = dw[0].weight.detach()[:, 0].permute(1, 2, 0).contiguous()
    out["sd"], out["bd"] = _fold_bn(dw[1])
    out["wp"] = proj.weight.detach()[:, :, 0, 0].t().contiguous()
    out["sp"], out["bp"] = _fold_bn(proj_bn)
    out["stride"], out["use_res"] = dw[0].stride[0], block.use_res
    return out


def _relu6(t: torch.Tensor) -> torch.Tensor:
    return t.clamp(0.0, 6.0)


def mbconv_plain(x, we, se, be, wd, sd, bd, wp, sp, bp, stride: int = 1,
                 use_res: bool = False) -> torch.Tensor:
    """Plain version, the same math with the hidden tensors materialized."""
    f32 = torch.float32
    y = x.to(f32)
    if we is not None:
        y = _relu6((y @ we.to(f32)) * se.to(f32) + be.to(f32))
    h, w = y.shape[1], y.shape[2]
    ho, wo = h // stride, w // stride
    yp = F.pad(y, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((y.shape[0], ho, wo, y.shape[-1]), dtype=f32, device=y.device)
    wd = wd.to(f32)
    for dy in range(3):
        for dx in range(3):
            tap = yp[:, dy:dy + h:stride, dx:dx + w:stride][:, :ho, :wo]
            acc = acc + tap * wd[dy, dx]
    z = _relu6(acc * sd.to(f32) + bd.to(f32))
    out = (z @ wp.to(f32)) * sp.to(f32) + bp.to(f32)
    if use_res:
        out = out + x.to(f32)
    return out.to(x.dtype)


def mbconv_plan(b: int, h: int, w: int, cin: int, hidden: int, cout: int, stride: int,
                sms: int, expand: bool = True) -> Tuple[int, int]:
    """(splits, channels per split): how many CTAs (one thread-block
    cluster) share the hidden channels of one output tile on the current
    card (with ``sms`` SMs), and how many hidden channels each takes (a
    multiple of 8). The rule is the kernel's own (``tpuseg_mbconv_plan``),
    which asks the occupancy API how many CTAs and clusters run at once."""
    splits, per = ctypes.c_int(), ctypes.c_int()
    rc = _c_fn("mbconv_plan")(b, h, w, cin, hidden, cout, stride, int(expand), sms,
                              ctypes.byref(splits), ctypes.byref(per))
    if rc != 0:
        raise RuntimeError(f"mbconv plan failed: CUDA error {rc}")
    return splits.value, per.value


def _shapes(x, we, se, be, wd, sd, bd, wp, sp, bp, stride, use_res):
    if x.ndim != 4:
        raise ValueError(f"x must be [B, H, W, Cin], got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    hidden, cout = wd.shape[-1], wp.shape[-1]
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if tuple(wd.shape) != (3, 3, hidden) or tuple(wp.shape) != (hidden, cout):
        raise ValueError("wd must be [3, 3, hidden] and wp [hidden, Cout]")
    if we is None:
        if cin != hidden or se is not None or be is not None:
            raise ValueError("without we, hidden must equal Cin and se/be be None")
    elif tuple(we.shape) != (cin, hidden):
        raise ValueError(f"we must be [Cin, hidden] = [{cin}, {hidden}]")
    for name, v, n in (("se", se, hidden), ("be", be, hidden), ("sd", sd, hidden),
                       ("bd", bd, hidden), ("sp", sp, cout), ("bp", bp, cout)):
        if v is not None and tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be [{n}]")
    if use_res and (stride != 1 or cin != cout):
        raise ValueError("use_res needs stride 1 and Cin == Cout")
    return b, h, w, cin, hidden, cout


def fused_inverted_residual(x: torch.Tensor, we: Optional[torch.Tensor], se, be,
                            wd: torch.Tensor, sd, bd, wp: torch.Tensor, sp, bp,
                            stride: int = 1, use_res: bool = False) -> torch.Tensor:
    """One inverted-residual block with both hidden tensors kept on chip.

    x [B,H,W,Cin]; we [Cin,hidden] or None (expand_ratio 1, then se and be
    are None too); wd [3,3,hidden]; wp [hidden,Cout]; se/be/sd/bd [hidden]
    and sp/bp [Cout] the folded BN affines. -> [B, H//s, W//s, Cout] in
    x's dtype (f32 or bf16)."""
    b, h, w, cin, hidden, cout = _shapes(x, we, se, be, wd, sd, bd, wp, sp, bp,
                                         stride, use_res)
    weights = dict(wd=wd, sd=sd, bd=bd, wp=wp, sp=sp, bp=bp)
    if we is not None:
        weights.update(we=we, se=se, be=be)
    if not _on_cuda(x, *weights.values()):
        return mbconv_plain(x, we, se, be, wd, sd, bd, wp, sp, bp, stride, use_res)
    _require_contiguous(ACTIVATION_DTYPES, x=x)
    _require_contiguous(**weights)
    ho, wo = h // stride, w // stride
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ptr = lambda t: None if t is None else t.data_ptr()
    _launch("mbconv", x.device, x.data_ptr(), ptr(we), ptr(se), ptr(be), wd.data_ptr(),
            sd.data_ptr(), bd.data_ptr(), wp.data_ptr(), sp.data_ptr(), bp.data_ptr(),
            out.data_ptr(), b, h, w, cin, hidden, cout, stride, int(use_res), sms,
            int(x.dtype == torch.bfloat16))
    launches["fused_inverted_residual"] += 1
    return out
