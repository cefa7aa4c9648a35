"""Lazy g++ build of the port's native host library.

The .so is cached under ``native/build/`` and rebuilt when the source is
newer. There is no numpy fallback: a failed build raises, so a run
never measures another path than the one it reports.
"""

import ctypes
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).parent
_SRC = _HERE / "src" / "second_native.cpp"
_BUILD_DIR = _HERE / "build"
_LIB = _BUILD_DIR / "libsecond_native.so"
_lock = threading.Lock()
_cdll = None


def _fresh():
    return _LIB.is_file() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime


def _build():
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = _BUILD_DIR / f"libsecond_native.{os.getpid()}.tmp.so"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-march=native", "-shared",
           "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed for {_SRC.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB)  # atomic: concurrent builders never load a torn file


def load_lib():
    """Build (once, or when the source changed) and ctypes-load the
    library. A library built with ``-march=native`` on another machine
    that fails to load is rebuilt once."""
    global _cdll
    with _lock:
        if _cdll is None:
            if not _fresh():
                _build()
            try:
                _cdll = ctypes.CDLL(str(_LIB))
            except OSError:
                _build()
                _cdll = ctypes.CDLL(str(_LIB))
        return _cdll
