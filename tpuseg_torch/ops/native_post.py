"""ctypes bindings for the native postprocess library (native/postprocess.cpp).

The port of ``tpuseg/ops/native_post.py``: morphological close, connected
components, keep-largest, component boxes, palette colorize, blend and the
fused colorize+blend, the op set the reference runs through OpenCV per
frame, as a dependency-free C++ library. On a host without cv2 (the H100
machine) it is the postprocess's only route for the road cleanup and the
blend.

Where the library comes from, in order:

1. ``native/libtpuseg_post.so`` as committed;
2. if that does not load (another glibc, a stale build), ``native/
   postprocess.cpp`` compiled at first use by the host C++ compiler
   (``$CXX``, else ``c++``) with ``native/Makefile``'s flags
   (``-O3 -fPIC -std=c++17 -shared``) into ``build/native/`` at the
   repository root (git-ignored), named by a hash of the source.

``library_path()`` says which file loaded. ``available()`` is False when
neither route gives a library; the postprocess then takes cv2 where it
imports, and raises naming both where it does not. The wrappers raise
RuntimeError without a library, with the reason it did not load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
COMMITTED = _ROOT / "native" / "libtpuseg_post.so"
SOURCE = _ROOT / "native" / "postprocess.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_PATH: Optional[Path] = None
_WHY = ""
_TRIED = False

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _built_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtpuseg_post-{digest}.so"


def _build() -> Path:
    """Compile native/postprocess.cpp with the host C++ compiler (once per
    source hash); raises OSError naming what failed."""
    dst = _built_path()
    if dst.exists():
        return dst
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise OSError("no C++ compiler ($CXX, c++ or g++) to build native/postprocess.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_name(f"{dst.name}.{os.getpid()}.tmp")
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise OSError(f"{cxx} failed on native/postprocess.cpp:\n{out.stderr}")
    os.replace(tmp, dst)
    return dst


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _PATH, _WHY, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    why = []
    try:
        _LIB, _PATH = _bind(ctypes.CDLL(str(COMMITTED))), COMMITTED
        return _LIB
    except (OSError, AttributeError) as e:
        why.append(str(e))
    try:
        path = _build()
        _LIB, _PATH = _bind(ctypes.CDLL(str(path))), path
    except (OSError, AttributeError, subprocess.TimeoutExpired) as e:
        why.append(f"build: {e}")
        _WHY = "; ".join(why)
    return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point's signature; raises AttributeError on a
    stale library missing one."""
    lib.tpuseg_morph_close.argtypes = [_u8p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tpuseg_keep_largest.restype = ctypes.c_int32
    lib.tpuseg_keep_largest.argtypes = [_u8p, _u8p, ctypes.c_int, ctypes.c_int]
    lib.tpuseg_label_components.restype = ctypes.c_int32
    lib.tpuseg_label_components.argtypes = [_u8p, _i32p, ctypes.c_int, ctypes.c_int]
    lib.tpuseg_component_boxes.restype = ctypes.c_int32
    lib.tpuseg_component_boxes.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int32,
                                           _i32p, ctypes.c_int32]
    lib.tpuseg_clean_road.restype = ctypes.c_int32
    lib.tpuseg_clean_road.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_uint8,
                                      ctypes.c_int]
    lib.tpuseg_colorize.argtypes = [_u8p, _u8p, ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_int]
    lib.tpuseg_blend.argtypes = [_u8p, _u8p, _u8p, ctypes.c_int, ctypes.c_float]
    lib.tpuseg_colorize_blend.argtypes = [_u8p, _u8p, _u8p, _u8p, ctypes.c_int]
    return lib


def available() -> bool:
    return _load() is not None


def has_colorize_blend() -> bool:
    """True when a library loaded: the port binds the fused colorize+blend
    entry with the others, so a library without it does not load."""
    return available()


def library_path() -> Optional[str]:
    """The library file that loaded, or None."""
    _load()
    return None if _PATH is None else str(_PATH)


def unavailable_reason() -> str:
    """Why no library loaded ('' when one did)."""
    _load()
    return _WHY


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native postprocess library did not load ({_WHY})")
    return lib


def _odd(kernel_size: int) -> None:
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd: the C++ close uses a symmetric radius, "
                         "an even size would run (k+1)x(k+1) where cv2 runs k x k")


def morph_close(mask: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    """Binary close with a kernel_size x kernel_size rect kernel (0/255 in,
    0/255 out)."""
    lib = _lib()
    _odd(kernel_size)
    mask = np.ascontiguousarray(mask, np.uint8)
    out = np.empty_like(mask)
    lib.tpuseg_morph_close(mask, out, mask.shape[0], mask.shape[1], kernel_size // 2)
    return out


def label_components(mask: np.ndarray) -> Tuple[int, np.ndarray]:
    lib = _lib()
    mask = np.ascontiguousarray(mask, np.uint8)
    labels = np.empty(mask.shape, np.int32)
    n = lib.tpuseg_label_components(mask, labels, mask.shape[0], mask.shape[1])
    return int(n), labels


def keep_largest(mask: np.ndarray) -> np.ndarray:
    lib = _lib()
    mask = np.ascontiguousarray(mask, np.uint8)
    out = np.empty_like(mask)
    lib.tpuseg_keep_largest(mask, out, mask.shape[0], mask.shape[1])
    return out


def component_boxes(mask: np.ndarray, min_area: int = 300,
                    max_boxes: int = 256) -> List[Tuple[int, int, int, int, int]]:
    """[(x, y, w, h, area)] of 8-connected components with area > min_area."""
    lib = _lib()
    mask = np.ascontiguousarray(mask, np.uint8)
    boxes = np.zeros((max_boxes, 5), np.int32)
    n = lib.tpuseg_component_boxes(mask, mask.shape[0], mask.shape[1], min_area, boxes,
                                   max_boxes)
    return [tuple(int(v) for v in row) for row in boxes[:n]]


def clean_road(classes: np.ndarray, road_class: int = 1, kernel_size: int = 5) -> np.ndarray:
    """Fused close + keep-largest + stamp, C++ single pass; returns a new map."""
    lib = _lib()
    _odd(kernel_size)
    out = np.ascontiguousarray(classes, np.uint8).copy()
    lib.tpuseg_clean_road(out, out.shape[0], out.shape[1], road_class, kernel_size // 2)
    return out


def colorize(classes: np.ndarray, palette: np.ndarray) -> np.ndarray:
    lib = _lib()
    classes = np.ascontiguousarray(classes, np.uint8)
    palette = np.ascontiguousarray(palette, np.uint8)
    out = np.empty((*classes.shape, 3), np.uint8)
    lib.tpuseg_colorize(classes, palette, palette.shape[0], out, classes.shape[0],
                        classes.shape[1])
    return out


def blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    lib = _lib()
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    if a.shape != b.shape:
        raise ValueError(f"blend: shape mismatch {a.shape} vs {b.shape}")
    out = np.empty_like(a)
    lib.tpuseg_blend(a, b, out, a.size, alpha)
    return out


def make_blend_lut(palette256: np.ndarray, alpha: float) -> np.ndarray:
    """[256, 3, 256] uint8 LUT: lut[c, ch, v] = clip(rint(v*(1-alpha) +
    palette*alpha)) in double with round-half-to-even, the expression of
    tpuseg_blend and cv2.addWeighted."""
    assert palette256.shape == (256, 3)
    v = np.arange(256, dtype=np.float64)
    p = palette256.astype(np.float64)
    mix = v[None, None, :] * (1.0 - alpha) + p[:, :, None] * alpha
    return np.clip(np.rint(mix), 0, 255).astype(np.uint8)


def colorize_blend(frame_bgr: np.ndarray, classes: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Fused out = blend(frame, palette[classes]) in one C++ pass (``lut``
    from make_blend_lut)."""
    lib = _lib()
    frame_bgr = np.ascontiguousarray(frame_bgr, np.uint8)
    classes = np.ascontiguousarray(classes, np.uint8)
    lut = np.ascontiguousarray(lut, np.uint8)
    # checked before the pointers reach C++: a model-size class map with a
    # frame-size image would write past the output buffer
    if frame_bgr.shape[:-1] != classes.shape or frame_bgr.shape[-1] != 3:
        raise ValueError(f"colorize_blend: frame {frame_bgr.shape} does not match classes "
                         f"{classes.shape} (upscale the class map first)")
    if lut.shape != (256, 3, 256):
        raise ValueError(f"colorize_blend: lut must be (256, 3, 256), got {lut.shape}")
    out = np.empty_like(frame_bgr)
    lib.tpuseg_colorize_blend(frame_bgr, classes, lut, out, classes.size)
    return out
