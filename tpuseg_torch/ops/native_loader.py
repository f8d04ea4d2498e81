"""ctypes bindings for the native batch loader (native/loader.cpp).

The port of ``tpuseg/ops/native_loader.py``: one memcpy gather per batch
from the packed dataset's memmaps (``PackedSource.load_batch``), in place
of a Python loop over samples. ctypes releases the GIL for the whole call,
so the loader thread does not hold the interpreter while it copies.

Where the library comes from is ``ops/_native.py``'s policy, as for
``ops/native_post.py``: the committed ``native/libtpuseg_loader.so``, else
``native/loader.cpp`` compiled at first use into ``build/native/``. A
library must also pass a known-answer gather before it is trusted.

``library_path()`` says which file loaded, ``unavailable_reason()`` why
none did. ``available()`` is False when neither route gives a library;
callers then gather with numpy, with identical bytes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from tpuseg_torch.ops._native import NativeLibrary

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry point and run the known-answer gather; raises
    OSError or AttributeError on a library that fails."""
    lib.tpuseg_gather2.restype = ctypes.c_int64
    lib.tpuseg_gather2.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,  # image source, bytes per sample
        ctypes.c_void_p, ctypes.c_int64,  # mask source, bytes per sample
        _i64p, ctypes.c_int64,            # indices, n
        _u8p, _u8p,                       # image out, mask out
    ]
    if not _self_test(lib):
        raise OSError(f"{lib._name}: the known-answer gather gave wrong bytes")
    return lib


def _self_test(lib: ctypes.CDLL) -> bool:
    """A tiny known-answer gather before trusting a library."""
    try:
        return _known_answer(lib)
    except Exception:   # a stale library with another signature
        return False


def _known_answer(lib: ctypes.CDLL) -> bool:
    img = np.arange(6, dtype=np.uint8).reshape(2, 3)
    msk = np.arange(4, dtype=np.uint8).reshape(2, 2)
    img_out = np.zeros((1, 3), np.uint8)
    msk_out = np.zeros((1, 2), np.uint8)
    idx = np.asarray([1], np.int64)
    lib.tpuseg_gather2(img.ctypes.data, 3, msk.ctypes.data, 2, idx, 1, img_out, msk_out)
    return bool(np.array_equal(img_out[0], img[1]) and np.array_equal(msk_out[0], msk[1]))


LIBRARY = NativeLibrary("libtpuseg_loader.so", "loader.cpp", _bind)


def available() -> bool:
    return LIBRARY.load() is not None


def library_path() -> Optional[str]:
    """The library file that loaded, or None."""
    return None if LIBRARY.path is None else str(LIBRARY.path)


def unavailable_reason() -> str:
    """Why no library loaded ('' when one did)."""
    return LIBRARY.why


def gather2(images: np.ndarray, masks: np.ndarray, indices: np.ndarray,
            img_out: np.ndarray, msk_out: np.ndarray) -> None:
    """Copy images[indices] -> img_out and masks[indices] -> msk_out.

    ``images``/``masks`` may be np.memmap; the outputs must be C-contiguous
    uint8 with the batch as the leading dim (a pinned tensor's ``.numpy()``
    view is)."""
    lib = LIBRARY.load()
    if lib is None:
        raise RuntimeError(f"the native loader did not load ({LIBRARY.why}); check available() "
                           "and gather with numpy")
    if not (hasattr(images, "ctypes") and hasattr(masks, "ctypes")):
        # a None pointer would send the C memcpy reading from address
        # idx * bytes: a segfault, not a Python error
        raise TypeError("gather2 requires ndarray/memmap inputs")
    for a in (images, masks):
        if a.dtype != np.uint8 or not a.flags["C_CONTIGUOUS"]:
            raise TypeError("gather2 requires C-contiguous uint8 sources")
    n = int(indices.shape[0])
    if img_out.shape[0] < n or msk_out.shape[0] < n:
        raise ValueError("gather2: output batch smaller than indices")
    if img_out.shape[1:] != images.shape[1:] or msk_out.shape[1:] != masks.shape[1:]:
        raise ValueError(f"gather2: outputs {img_out.shape[1:]}, {msk_out.shape[1:]} do not "
                         f"match samples {images.shape[1:]}, {masks.shape[1:]}")
    idx = np.ascontiguousarray(indices, np.int64)
    size = min(len(images), len(masks))
    if n and (idx.min() < 0 or idx.max() >= size):
        raise IndexError(f"gather2: indices outside [0, {size})")
    lib.tpuseg_gather2(images.ctypes.data, int(np.prod(images.shape[1:])), masks.ctypes.data,
                       int(np.prod(masks.shape[1:])), idx, n, img_out, msk_out)
