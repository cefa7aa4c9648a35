"""nvcc build of the port's hand-written CUDA kernels, loaded with ctypes.

Each ``csrc/<name>.cu`` holds one kernel behind a plain C entry point.
At first use it is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into
``csrc/build/lib<name>.so`` and loaded with :mod:`ctypes`. Compiling a
file with a plain C interface takes seconds; nothing here includes
PyTorch's headers. There is no fallback: a missing ``nvcc`` or a
failed build raises. The ptxas report (registers, shared memory,
spills) of each build is kept beside the library as
``<name>.ptxas.log``.

Same pattern as ``second_tpu/native/build.py`` (lazy build next to the
sources, rebuilt when the source or a shared ``csrc/*.cuh`` header is
newer than the library).
"""

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_name_locks = {}  # one per kernel: different kernels build concurrently
_libs = {}


def nvcc_path():
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the
    ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built at first "
            "use; install the CUDA toolkit or set CUDA_HOME")
    return found


def _compile(name, extra_flags):
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [nvcc_path(), *ARCH_FLAGS, *BASE_FLAGS, *extra_flags,
           str(src), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    (BUILD_DIR / f"{name}.ptxas.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never load a torn file
    return lib


def load(name, extra_flags=()):
    """Build (once per process, or when the source changed) and
    ctypes-load ``csrc/<name>.cu``. Returns the ``ctypes.CDLL``."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        lib = BUILD_DIR / f"lib{name}.so"
        newest = max(p.stat().st_mtime
                     for p in (src, *CSRC.glob("*.cuh")))
        if not lib.is_file() or lib.stat().st_mtime < newest:
            lib = _compile(name, tuple(extra_flags))
        cdll = ctypes.CDLL(str(lib))
        cdll.cuda_error_string.argtypes = [ctypes.c_int]
        cdll.cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = cdll
        return cdll


def check(lib, code, what):
    """Raise when a C launch function returned a CUDA error code
    (its ``cudaGetLastError()`` right after the launch)."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptxas_report(name):
    """The ptxas lines of the last build of ``name`` ('' if none)."""
    log = BUILD_DIR / f"{name}.ptxas.log"
    if not log.is_file():
        return ""
    return "\n".join(line for line in log.read_text().splitlines()
                     if "ptxas" in line)
