"""Disk-backed minibatch datasets with a native prefetching loader
(counterpart of ``gpflow_slim_tpu.io.dataset``).

At production scale (BASELINE config #3, N=100k and more) the data lives
on disk and the host has to overlap its reads with the device's work. The
hot path is C (``native/loader.c``, this package's own copy of the JAX
package's loader): a pread row gather and a background prefetch thread. It
is compiled with ``cc -O2 -shared`` at first use into ``build/loader/``
beside the package (listed in ``.gitignore``), keyed by a hash of the
source, and loaded by ctypes. ``use_native=False`` reads through a numpy
memmap instead; asking for the native loader where no C compiler is found
raises.

The file format is the JAX package's, byte for byte: a file written by
either package reads back in the other::

    path = io.write_gfsb("train.gfsb", np.hstack([X, Y]))
    ds = io.BinaryDataset(path)
    for batch in ds.minibatches(torch.Generator().manual_seed(0), 1024, 100):
        xb = batch.to("cuda", non_blocking=True)  # batch t+1 is read meanwhile
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

__all__ = ["write_gfsb", "BinaryDataset"]

_MAGIC = b"GFSB"
_HEADER = 4 + 2 * 8  # magic, int64 rows, int64 cols
SOURCE = Path(__file__).resolve().parent / "native" / "loader.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "loader"
COMPILERS = ("cc", "gcc", "clang")


def write_gfsb(path: str, array) -> str:
    """Write a rank-2 float32 array in the GFSB format (``array``: a numpy
    array or a tensor)."""
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(array, dtype=np.float32))
    if a.ndim != 2:
        raise ValueError("GFSB stores rank-2 arrays")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(np.asarray(a.shape, dtype=np.int64).tobytes())
        f.write(a.tobytes())
    return path


def library_path() -> Path:
    """Where the loader built from the current source goes."""
    return BUILD_DIR / f"_loader_{hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]}.so"


@functools.cache
def load_native() -> ctypes.CDLL:
    """Compile the loader (once per source) and load it; raise if no C
    compiler is found or the build fails."""
    so = library_path()
    if not so.exists():
        cc = next((c for c in map(shutil.which, COMPILERS) if c), None)
        if cc is None:
            raise RuntimeError(f"no C compiler ({', '.join(COMPILERS)}) to build {SOURCE.name}: pass "
                               "use_native=False to read through numpy's memmap")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        proc = subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE), "-lpthread"],
                              capture_output=True, text=True, timeout=120, check=False)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cc} failed to build {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(so))
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    for name, restype, argtypes in (("gfs_open", P, [ctypes.c_char_p]), ("gfs_rows", L, [P]),
                                    ("gfs_cols", L, [P]), ("gfs_gather", I, [P, P, L, P]),
                                    ("gfs_prefetch_submit", I, [P, P, L]), ("gfs_prefetch_wait", I, [P, P, L]),
                                    ("gfs_close", None, [P])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


class BinaryDataset:
    """Random-access GFSB reader with double-buffered minibatching.

    ``rows`` and ``cols`` give its shape; ``native`` whether the C loader
    reads it. ``gather`` and ``minibatches`` return float32 CPU tensors."""

    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(_HEADER)
        if len(head) != _HEADER or head[:4] != _MAGIC:
            raise ValueError(f"{path}: not a GFSB file")
        self.rows, self.cols = (int(d) for d in np.frombuffer(head[4:], dtype=np.int64))
        self.native = bool(use_native)
        self._h = None
        if self.native:
            self._lib = load_native()
            self._h = self._lib.gfs_open(os.fsencode(path))
            if not self._h:
                raise IOError(f"{path}: the native loader could not open it")
        else:
            self._mm = np.memmap(path, dtype=np.float32, mode="r", offset=_HEADER, shape=(self.rows, self.cols))

    def _out(self, n, pin_memory=False):
        return torch.empty((n, self.cols), dtype=torch.float32, pin_memory=pin_memory)

    # -- random-access gather ----------------------------------------------
    def gather(self, indices) -> torch.Tensor:
        """Rows ``indices`` (a tensor, array or sequence of ints), (n, cols)."""
        idx = np.ascontiguousarray(torch.as_tensor(indices).cpu().numpy(), dtype=np.int64)
        if not self.native:
            return torch.from_numpy(np.array(self._mm[idx]))
        out = self._out(len(idx))
        rc = self._lib.gfs_gather(self._h, idx.ctypes.data, len(idx), out.data_ptr())
        if rc != 0:
            raise IOError(f"native gather failed (rc={rc})")
        return out

    # -- double-buffered minibatch stream -----------------------------------
    def minibatches(self, generator: torch.Generator, batch_size: int, num_batches: int,
                    pin_memory: bool = False):
        """Yield ``num_batches`` minibatches of ``batch_size`` rows drawn
        uniformly with replacement (``torch.randint`` from ``generator``, a
        CPU generator, where the JAX package draws from a key), each a
        float32 CPU tensor (batch_size, cols). On the native loader the
        worker thread reads batch t+1 while the caller computes on batch t.
        ``pin_memory``: the batches are in page-locked memory, so their copy
        to the card can be ``non_blocking``."""

        def sample_idx():
            return torch.randint(0, self.rows, (batch_size,), generator=generator).numpy()

        if not self.native:
            for _ in range(num_batches):
                batch = self.gather(sample_idx())
                yield batch.pin_memory() if pin_memory else batch
            return
        if num_batches <= 0:
            return
        self._submit(sample_idx())
        for t in range(num_batches):
            out = self._wait(batch_size, pin_memory)
            if t + 1 < num_batches:
                self._submit(sample_idx())
            yield out

    def _submit(self, idx):
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        rc = self._lib.gfs_prefetch_submit(self._h, idx.ctypes.data, len(idx))
        if rc != 0:
            raise IOError(f"prefetch submit failed (rc={rc})")

    def _wait(self, n, pin_memory) -> torch.Tensor:
        out = self._out(n, pin_memory)
        rc = self._lib.gfs_prefetch_wait(self._h, out.data_ptr(), n)
        if rc != 0:
            raise IOError(f"prefetch wait failed (rc={rc})")
        return out

    def close(self):
        if getattr(self, "_h", None):  # not set where __init__ raised first
            self._lib.gfs_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
