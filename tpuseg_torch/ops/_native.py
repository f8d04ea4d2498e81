"""Where a native host library under ``native/`` comes from, and binding it.

One policy for ``native_post`` and ``native_loader``. In order:

1. the committed ``native/lib<name>.so``;
2. if that does not load or its bind check fails (another glibc, a stale
   build), the C++ source beside it compiled at first use by the host C++
   compiler (``$CXX``, else ``c++``) with ``native/Makefile``'s flags
   (``-O3 -fPIC -std=c++17 -shared``) into ``build/native/`` at the
   repository root (git-ignored), named by a hash of the source.

``NativeLibrary.load()`` tries once and remembers the outcome; ``path``
says which file loaded and ``why`` why none did.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


class NativeLibrary:
    """``committed`` and ``source`` are file names under ``native/``;
    ``bind`` declares the entry points of a freshly opened CDLL (and may
    check it), raising OSError or AttributeError on a library that fails."""

    def __init__(self, committed: str, source: str, bind: Callable[[ctypes.CDLL], ctypes.CDLL]):
        self.committed = ROOT / "native" / committed
        self.source = ROOT / "native" / source
        self.build_dir = ROOT / "build" / "native"
        self.bind = bind
        self._loaded: Optional[Tuple[Optional[ctypes.CDLL], Optional[Path], str]] = None

    def built_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
        return self.build_dir / f"{self.committed.stem}-{digest}.so"

    def build(self) -> Path:
        """Compile the source with the host C++ compiler (once per source
        hash); raises OSError naming what failed."""
        dst = self.built_path()
        if dst.exists():
            return dst
        cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
        if not cxx:
            raise OSError(f"no C++ compiler ($CXX, c++ or g++) to build native/{self.source.name}")
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_name(f"{dst.name}.{os.getpid()}.tmp")
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(self.source)],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise OSError(f"{cxx} failed on native/{self.source.name}:\n{out.stderr}")
        os.replace(tmp, dst)
        return dst

    def load(self) -> Optional[ctypes.CDLL]:
        """The bound library, or None when neither route gives one."""
        if self._loaded is None:
            self._loaded = self._try()
        return self._loaded[0]

    def _try(self) -> Tuple[Optional[ctypes.CDLL], Optional[Path], str]:
        why = []
        try:
            return self.bind(ctypes.CDLL(str(self.committed))), self.committed, ""
        except (OSError, AttributeError) as e:
            why.append(str(e))
        try:
            path = self.build()
            return self.bind(ctypes.CDLL(str(path))), path, ""
        except (OSError, AttributeError, subprocess.TimeoutExpired) as e:
            why.append(f"build: {e}")
        return None, None, "; ".join(why)

    @property
    def path(self) -> Optional[Path]:
        self.load()
        return self._loaded[1]

    @property
    def why(self) -> str:
        self.load()
        return self._loaded[2]
