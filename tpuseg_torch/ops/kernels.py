"""The serving path's three CUDA kernels: wrappers, plain versions, counters.

Ports of the Pallas kernels in ``tpuseg/ops/pallas_kernels.py``:

=============================  ============================  =====================
wrapper (JAX signature, NHWC)   CUDA source (tpuseg_torch/)   plain PyTorch version
=============================  ============================  =====================
argmax_colorize                 csrc/argmax_colorize.cu       argmax_colorize_plain
upsample2x_argmax               csrc/upsample2x_argmax.cu     upsample2x_argmax_plain
fused_upsample_concat_conv      csrc/upconcat_conv.cu         fused_upconcat_plain
=============================  ============================  =====================

Dispatch goes by the tensor's device and nothing else: a CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises. There is no
fallback from the kernel to the plain version, and none of the TPU
wrappers' shape-based fallbacks: the kernels mask their own ragged edges.

``_SIGNATURES`` also binds the C entry points of the Lovász kernels
(``ops/lovasz.py``), the block kernel (``ops/mbconv.py``) and the cascaded
x2 upsample pair (``ops/upsample.py``, which ``ops/resize.py`` dispatches
to on the card); their wrappers live in those modules. The plain versions
here upsample with ``resize_bilinear``, so on the card they stay plain.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if the
launch reports an error, and adds one to ``launches[<wrapper name>]``.

Activations and logits may be fp32 or bf16, as the JAX functions take
them (bf16 compute, ``ModelConfig.compute_dtype``): each kernel widens
bf16 to fp32 as it reads and computes in fp32, and the decoder writes fp32
(its caller rounds). On the card any other dtype raises ``TypeError``;
weights and biases are fp32.

The designs, and what bounds each on the H100 (the sources say more):

- ``argmax_colorize``: one thread per pixel; bound by the bytes of the
  logits.
- ``upsample2x_argmax``: one CTA per image and band of 4 source rows
  stages the 6 source rows the band needs into shared memory (16-byte
  ``cp.async``, one barrier). A thread owns one source pixel and its 2x2
  output block (the x2 taps' fixed shape): it lerps its column in H once
  per output row, takes its neighbours' columns by warp shuffles, lerps in
  W and stores two 16-bit words. Bound by the bytes of the logits (0.00086
  ms at [8,64,128,10]), which lie below the cost of one launch; at that
  size the instructions per output pixel set the pace.
- ``fused_upsample_concat_conv``: an implicit GEMM (M = output pixels,
  N = Cout, K = 9 (Cs + Cx)) on the tensor cores, exact to fp32 through the
  3xTF32 split (big*big + big*small + small*big in ``mma.sync`` tf32). The
  skip channels and the weights are staged with ``cp.async`` into a
  double-buffered ring; the upsampled x channels are rebuilt in shared
  memory from a staged x patch. Bound by operations: 3 TF32 products per
  fp32 term at 495 TFLOP/s (0.091 ms for the decoder's four calls at batch
  8 and 256x128), against 0.223 ms for exact fp32 on the CUDA cores. Where
  the output tiles are too few to fill the card, K is split over blocks
  (``upconcat_plan``, the kernel's own rule) into scratch that the wrapper
  allocates, and a second kernel sums the splits in a fixed order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the launch counters: ``core/trace.py``, with the port's spans
from tpuseg_torch.core.trace import launches, reset_launches  # noqa: F401
from tpuseg_torch.ops.resize import _bilinear_taps, resize_bilinear

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C symbol, argument types (pointers and the stream as void*)
# (the int before the stream of the first three and mbconv: nonzero for bf16
# activations)
_SIGNATURES = {
    "argmax_colorize": ("tpuseg_argmax_colorize", [_P, _P, _P, _P, _LL, _I, _I, _P]),
    "upsample2x_argmax": ("tpuseg_upsample2x_argmax", [_P] * 4 + [_I] * 5 + [_P]),
    "upconcat_conv": ("tpuseg_upconcat_conv", [_P] * 6 + [_I] * 8 + [_P]),
    "upconcat_plan": ("tpuseg_upconcat_plan", [_I] * 7 + [_P, _P]),
    "lovasz_histograms": ("tpuseg_lovasz_histograms", [_P, _P, _P, _P, _I, _LL, _I, _P]),
    "lovasz_hist_plan": ("tpuseg_lovasz_hist_plan", [_I, _LL, _I, _P]),
    "lovasz_lookup": ("tpuseg_lovasz_lookup", [_P, _P, _P, _I, _LL, _I, _P]),
    "lovasz_logits_plan": ("tpuseg_lovasz_logits_plan", [_I, _LL, _I, _P]),
    "lovasz_logits_scratch": ("tpuseg_lovasz_logits_scratch", [_I, _LL, _I, _I, _P]),
    "lovasz_logits_histograms": ("tpuseg_lovasz_logits_histograms",
                                 [_P] * 4 + [_I, _LL, _LL, _LL, _I, _LL, _I, _I, _P]),
    "lovasz_logits_grad": ("tpuseg_lovasz_logits_grad",
                           [_P] * 6 + [_I, _LL, _LL, _LL, _I, _LL, _I, _I, _P]),
    "mbconv": ("tpuseg_mbconv", [_P] * 11 + [_I] * 10 + [_P]),
    "mbconv_plan": ("tpuseg_mbconv_plan", [_I] * 9 + [_P, _P]),
    "upsample_pow2": ("tpuseg_upsample_pow2", [_P] * 3 + [_I] * 12 + [_P]),
    "upsample_pow2_grad": ("tpuseg_upsample_pow2_grad", [_P] * 3 + [_I] * 15 + [_P]),
    "upsample_pow2_limits": ("tpuseg_upsample_pow2_limits", [_P]),
}
# symbols that live in another source's library
_LIBRARY = {"mbconv_plan": "mbconv", "upconcat_plan": "upconcat_conv",
            "lovasz_hist_plan": "lovasz_histograms", "lovasz_logits_plan": "lovasz_logits",
            "lovasz_logits_scratch": "lovasz_logits",
            "lovasz_logits_histograms": "lovasz_logits", "lovasz_logits_grad": "lovasz_logits",
            "upsample_pow2_grad": "upsample_pow2", "upsample_pow2_limits": "upsample_pow2"}


@functools.lru_cache(maxsize=None)
def _c_fn(source: str):
    from tpuseg_torch.ops import _build

    symbol, argtypes = _SIGNATURES[source]
    fn = getattr(_build.load(_LIBRARY.get(source, source)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(source: str, device: torch.device, *args) -> None:
    """Call the C launcher on ``device``'s current stream; raise on error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _c_fn(source)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {rc}")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch), False for CPU tensors (plain)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


ACTIVATION_DTYPES = (torch.float32, torch.bfloat16)


def _require_contiguous(dtypes=(torch.float32,), **tensors: torch.Tensor) -> None:
    """Each tensor contiguous and of one of ``dtypes`` (TypeError)."""
    for name, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")



# ---------------------------------------------------------------------------
# argmax + palette colorize


def _pack_palette(palette_rgb: np.ndarray) -> np.ndarray:
    """[C, 3] uint8 -> [C] uint32 packed 0x00RRGGBB."""
    p = np.asarray(palette_rgb).astype(np.uint32)
    return (p[:, 0] << 16) | (p[:, 1] << 8) | p[:, 2]


def unpack_colors(packed: np.ndarray) -> np.ndarray:
    """Host-side: uint32 0x00RRGGBB [..., H, W] -> uint8 [..., H, W, 3]."""
    p = np.asarray(packed)
    return np.stack(
        [(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], axis=-1
    ).astype(np.uint8)


@functools.lru_cache(maxsize=16)
def _palette_words(palette_bytes: bytes, n: int, device: torch.device) -> torch.Tensor:
    """The packed palette as int32 words on ``device`` (one copy per device)."""
    pal = np.frombuffer(palette_bytes, np.uint8).reshape(n, 3)
    return torch.from_numpy(_pack_palette(pal).astype(np.int32)).to(device)


def _words_for(palette_rgb: np.ndarray, device: torch.device) -> torch.Tensor:
    pal = np.ascontiguousarray(palette_rgb, np.uint8)
    return _palette_words(pal.tobytes(), pal.shape[0], device)


def argmax_colorize_plain(logits: torch.Tensor, palette_rgb: np.ndarray):
    """Plain version: (argmax as uint8, packed palette colour as uint32)."""
    classes = logits.argmax(dim=-1)
    words = _words_for(palette_rgb, logits.device)
    return classes.to(torch.uint8), words[classes].view(torch.uint32)


def argmax_colorize(logits: torch.Tensor, palette_rgb: np.ndarray):
    """Fused argmax + colorize: logits [B, H, W, C] f32 or bf16 -> (uint8
    [B,H,W] classes, uint32 [B,H,W] packed 0x00RRGGBB colours)."""
    if logits.ndim != 4:
        raise ValueError(f"logits must be [B, H, W, C], got {tuple(logits.shape)}")
    c = logits.shape[-1]
    if not 1 <= c <= min(256, len(palette_rgb)):
        raise ValueError(
            f"{c} classes need 1..256 classes and a palette entry each "
            f"(palette has {len(palette_rgb)})"
        )
    if not _on_cuda(logits):
        return argmax_colorize_plain(logits, palette_rgb)
    _require_contiguous(ACTIVATION_DTYPES, logits=logits)
    b, h, w, _ = logits.shape
    classes = torch.empty((b, h, w), dtype=torch.uint8, device=logits.device)
    colors = torch.empty((b, h, w), dtype=torch.uint32, device=logits.device)
    words = _words_for(palette_rgb, logits.device)
    _launch("argmax_colorize", logits.device, logits.data_ptr(), words.data_ptr(),
            classes.data_ptr(), colors.data_ptr(), b * h * w, c,
            int(logits.dtype == torch.bfloat16))
    launches["argmax_colorize"] += 1
    return classes, colors


# ---------------------------------------------------------------------------
# fused final x2 (align_corners=True) upsample + argmax


def upsample2x_argmax_plain(logits: torch.Tensor) -> torch.Tensor:
    """Plain version: argmax(upsample2x_bilinear(logits, ac=True)) as uint8
    (``resize_bilinear``'s x2, which a CUDA tensor takes too)."""
    h, w = logits.shape[-3:-1]
    up = resize_bilinear(logits.to(torch.float32), 2 * h, 2 * w, align_corners=True)
    return up.argmax(dim=-1).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _ac_true_tap_table(n: int, device: torch.device) -> torch.Tensor:
    """int32 [2n, 4]: {lo, hi, float32 bits of 1 - frac, of frac} of each
    output index of the x2 align_corners=True upsample of n inputs: the
    plain version's own taps, made once per size and device."""
    lo, hi, frac = _bilinear_taps(n, 2 * n, True)
    table = np.stack([lo, hi, (np.float32(1.0) - frac).view(np.int32), frac.view(np.int32)],
                     axis=1).astype(np.int32)
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(table)).to(device)


def upsample2x_argmax(logits: torch.Tensor) -> torch.Tensor:
    """argmax over C of the exact x2 align_corners=True bilinear upsample.

    logits [B, H, W, C] f32 or bf16 (widened to f32, as the JAX function
    widens) -> classes uint8 [B, 2H, 2W]; the full-resolution logits are
    never materialized."""
    if logits.ndim != 4:
        raise ValueError(f"logits must be [B, H, W, C], got {tuple(logits.shape)}")
    if not 1 <= logits.shape[-1] <= 256:
        raise ValueError(f"uint8 classes need 1..256 classes, got {logits.shape[-1]}")
    if not _on_cuda(logits):
        return upsample2x_argmax_plain(logits)
    _require_contiguous(ACTIVATION_DTYPES, logits=logits)
    b, h, w, c = logits.shape
    out = torch.empty((b, 2 * h, 2 * w), dtype=torch.uint8, device=logits.device)
    rows, cols = (_ac_true_tap_table(n, logits.device) for n in (h, w))
    _launch("upsample2x_argmax", logits.device, logits.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), out.data_ptr(), b, h, w, c, int(logits.dtype == torch.bfloat16))
    launches["upsample2x_argmax"] += 1
    return out


# ---------------------------------------------------------------------------
# fused decoder upsample + concat + conv3x3


def fused_upconcat_plain(skip: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Plain version: conv3x3(cat([skip, up2x(x)]), w) + b, NHWC/HWIO, fp32
    (skip and x widened first, as the JAX kernel widens its blocks)."""
    up = resize_bilinear(x.to(torch.float32), 2 * x.shape[-3], 2 * x.shape[-2])
    cat = torch.cat([skip.to(torch.float32), up], dim=-1)
    y = F.conv2d(cat.permute(0, 3, 1, 2), w.to(torch.float32).permute(3, 2, 0, 1),
                 padding=1)
    return (y.permute(0, 2, 3, 1) + b.to(torch.float32)).contiguous()


def _upconcat_shapes(skip, x, w, b) -> Tuple[int, ...]:
    if skip.ndim != 4 or x.ndim != 4 or w.ndim != 4 or b.ndim != 1:
        raise ValueError("expected skip/x NHWC, w HWIO [3,3,Cin,Cout], b [Cout]")
    bsz, h2, w2, cs = skip.shape
    bx, h, wd, cx = x.shape
    cout = w.shape[-1]
    if (bx != bsz or h2 != 2 * h or w2 != 2 * wd or tuple(w.shape[:3]) != (3, 3, cs + cx)
            or b.shape[0] != cout):
        raise ValueError("shape mismatch between skip, x and w")
    return bsz, h2, w2, cs, cx, cout


def upconcat_plan(b: int, h2: int, w2: int, cs: int, cx: int, cout: int,
                  sms: int) -> Tuple[int, int]:
    """(splits, chunks per split): how the decoder kernel splits K (the
    16-channel chunks of Cs + Cx) over CUDA blocks on a card with ``sms``
    SMs. The rule is the kernel's own (``tpuseg_upconcat_plan``)."""
    splits, per = ctypes.c_int(), ctypes.c_int()
    rc = _c_fn("upconcat_plan")(b, h2, w2, cs, cx, cout, sms, ctypes.byref(splits),
                                ctypes.byref(per))
    if rc != 0:
        raise RuntimeError(f"upconcat plan failed: CUDA error {rc}")
    return splits.value, per.value


def fused_upsample_concat_conv(skip: torch.Tensor, x: torch.Tensor,
                               w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv3x3(cat([skip, up2x(x)]), w) + b without materializing either
    intermediate. skip [B,2H,2W,Cs] and x [B,H,W,Cx] (f32, or both bf16),
    w [3,3,Cs+Cx,Cout] and b [Cout] f32 -> f32 [B,2H,2W,Cout]."""
    bsz, h2, w2, cs, cx, cout = _upconcat_shapes(skip, x, w, b)
    if not _on_cuda(skip, x, w, b):
        return fused_upconcat_plain(skip, x, w, b)
    _require_contiguous(ACTIVATION_DTYPES, skip=skip, x=x)
    _require_contiguous(w=w, b=b)
    if skip.dtype != x.dtype:
        raise TypeError(f"skip and x must share a dtype, got {skip.dtype} and {x.dtype}")
    out = torch.empty((bsz, h2, w2, cout), dtype=torch.float32, device=skip.device)
    sms = torch.cuda.get_device_properties(skip.device).multi_processor_count
    splits, _ = upconcat_plan(bsz, h2, w2, cs, cx, cout, sms)
    partial = (torch.empty((splits, bsz, h2, w2, cout), dtype=torch.float32,
                           device=skip.device) if splits > 1 else None)
    _launch("upconcat_conv", skip.device, skip.data_ptr(), x.data_ptr(), w.data_ptr(),
            b.data_ptr(), out.data_ptr(), None if partial is None else partial.data_ptr(),
            bsz, h2, w2, cs, cx, cout, sms, int(x.dtype == torch.bfloat16))
    launches["fused_upsample_concat_conv"] += 1
    return out
