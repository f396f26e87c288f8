"""Build and load the hand-written CUDA kernels.

``load_library()`` compiles every ``csrc/*.cu`` of the package with nvcc,
one nvcc per source, all started together, links the objects into one
shared library with a plain C interface, on first use, and loads it with
ctypes. The output goes to ``build/kernels/`` beside the package
(listed in ``.gitignore``) and is keyed by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads at once. A missing
nvcc or a failed build raises with the compiler's output.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills, into the build log
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: name -> argument types (each returns a cudaError_t as int)
_ENTRIES = {
    # X, N, D, var, noise, kind, pad_to, out, stream
    "gfs_gram_chol_operand": (_P, _I, _I, _P, _P, _I, _I, _P, _P),
    # K, Np, alpha, P, work, half_logdet, stream
    "gfs_chol_solve_logdet": (_P, _I, _P, _I, _P, _P, _P),
    # X, N, X2, M, D, var, kind, out, stream
    "gfs_gram": (_P, _I, _P, _I, _I, _P, _I, _P, _P),
    # X, N, D, var, kind, out, stream
    "gfs_gram_lower": (_P, _I, _I, _P, _I, _P, _P),
    # K, Np, work, stream
    "gfs_cholesky": (_P, _I, _P, _P),
    # L, N, ld, trans, lower, X, P, sync, stream
    "gfs_trsm": (_P, _I, _I, _I, _I, _P, _I, _P, _P),
    # L, P, M, ld, batch_stride, trans, lower, B, X, K, sync, stream
    "gfs_batched_trsm": (_P, _I, _I, _I, _L, _I, _I, _P, _P, _I, _P, _P),
}


NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append(NVCC_FALLBACK)
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of gpflow_slim_tpu_torch are built from csrc/ on first use"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libgfs_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if their library is not built yet; return its path.

    One nvcc per source, all running at once, then one link."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    tmp.mkdir(exist_ok=True)
    try:
        jobs = []
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp / f"{src.stem}.o"), str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                               text=True)))
        log, failed = [], []
        for cmd, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(proc.returncode)
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp / so.name), *map(str, sorted(tmp.glob("*.o")))]
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
            log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append(proc.returncode)
        so.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed with exit code {failed[0]}:\n{''.join(log)}")
        os.replace(tmp / so.name, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.gfs_error_string.argtypes = [ctypes.c_int]
    lib.gfs_error_string.restype = ctypes.c_char_p
    return lib


def stream_of(x: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``x``'s device, for a C
    entry point (without building the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream`` returns)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.gfs_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
