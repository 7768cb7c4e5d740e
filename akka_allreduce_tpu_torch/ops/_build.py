"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers: seconds to build instead of minutes). The build happens at first
use, into ``build/torch_kernels/`` at the root of the checkout, under a file
name that carries a hash of the source, the shared headers and the flags, so
a stale library is never loaded. A file lock keeps two processes from racing on one build. A failed
build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of nvcc, from PyTorch's search for the CUDA toolkit
    (``$CUDA_HOME``, then ``nvcc`` on ``PATH``, then the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (named by a hash of the source, the
    shared ``csrc/*.cuh`` headers and the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile every named source that is not built yet, all nvcc processes
    started together; returns each library's path. ptxas's report (registers,
    spills) is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            procs = {}
            for n, so in paths.items():
                if so.exists():
                    continue
                tmp = so.with_suffix(f".tmp{os.getpid()}")
                cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
                procs[n] = (
                    subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True,
                    ),
                    tmp,
                    cmd,
                )
            failures = []
            for n, (proc, tmp, cmd) in procs.items():
                out, _ = proc.communicate()
                so = paths[n]
                so.with_suffix(".log").write_text(out)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    failures.append(f"$ {' '.join(cmd)}\n{out}")
                else:
                    os.replace(tmp, so)
            if failures:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[name]))
            lib.akka_error_string.argtypes = [ctypes.c_int]
            lib.akka_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if rc != 0:
        msg = lib.akka_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
