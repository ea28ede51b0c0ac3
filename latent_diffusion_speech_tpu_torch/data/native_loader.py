"""ctypes binding to the native npy batch reader (`data/native/npy_batch.cc`).

Counterpart of `latent_diffusion_speech_tpu/data/native_loader.py`.  The
library is host C++ (g++ -O3), built on first use into the port's build
directory (`$LDS_TORCH_BUILD_DIR`, else `latent_diffusion_speech_tpu_torch/_build`)
under a name keyed on the source hash, so a changed source always gets a
fresh binary.  The GIL is released for the whole batch read.

The build is serialised across processes, not only threads: an exclusive
`fcntl.flock` on a lock file beside the library is held while one process
compiles to a name of its own (pid-suffixed) and `os.replace`s it into place;
a process that waited on the lock finds the library built.  Spawned loader
workers that start together on an empty build directory therefore build it
once and all load it.  A failed compile or `dlopen` raises with the
compiler's stderr: there is no quiet numpy fallback.

`read_batch_bf16` converts f32 to bfloat16 (round to nearest even, NaNs
canonical) inside the read pass and returns the bits as a uint16 array;
`torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)` reads them as
bfloat16 (numpy has no bfloat16 of its own).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = ["NativeNpyReader", "build_dir", "library_path", "load_library"]

_SRC = Path(__file__).parent / "native" / "npy_batch.cc"
_CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
_DTYPES = {b"f": np.float32, b"e": np.float16, b"i": np.int32, b"q": np.int64}

_lock = threading.Lock()  # one loader per process; flock serialises processes
_lib = None


def build_dir() -> Path:
    return Path(os.environ.get("LDS_TORCH_BUILD_DIR", Path(__file__).resolve().parents[1] / "_build"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    return build_dir() / f"libnpy_batch.{digest}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "npy_batch.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():  # another process built it while this one waited
            return
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {_SRC.name} failed (g++ exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            tmp.unlink(missing_ok=True)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the reader library; raises
    RuntimeError with the compiler's stderr or the `dlopen` error."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:  # not a read failure: the loader must not fall back on it
            raise RuntimeError(f"loading {so} failed: {e}") from e
        lib.npy_pool_create.restype = ctypes.c_void_p
        lib.npy_pool_create.argtypes = [ctypes.c_int]
        lib.npy_pool_destroy.restype = None
        lib.npy_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.npy_probe.restype = ctypes.c_int
        lib.npy_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_char),
        ]
        lib.npy_read_batch.restype = ctypes.c_int
        lib.npy_read_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_uint64,
            ctypes.c_char_p,
        ]
        lib.npy_read_batch_bf16.restype = ctypes.c_int
        lib.npy_read_batch_bf16.argtypes = lib.npy_read_batch.argtypes
        _lib = lib
        return lib


class NativeNpyReader:
    """Thread-pooled cropped batch reads over npy files."""

    def __init__(self, num_threads: int = 4):
        self._lib = load_library()
        self._pool = self._lib.npy_pool_create(num_threads)

    def __del__(self):
        if getattr(self, "_pool", None):
            self._lib.npy_pool_destroy(self._pool)
            self._pool = None

    def probe(self, path: str | Path):
        """(rows, row_bytes, numpy dtype) of an npy file; OSError when it
        cannot be opened or parsed."""
        rows, row_bytes, dtype = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_char()
        rc = self._lib.npy_probe(str(path).encode(), ctypes.byref(rows), ctypes.byref(row_bytes),
                                 ctypes.byref(dtype))
        if rc != 0:
            raise OSError(f"npy_probe failed ({rc}) for {path}")
        return rows.value, row_bytes.value, _DTYPES[dtype.value]

    def _read(self, entry, paths, starts, count, row_bytes, out) -> np.ndarray:
        n = len(paths)
        if len(starts) != n or count < 0 or any(int(s) < 0 for s in starts):
            raise ValueError("read_batch: one non-negative start per path and count >= 0")
        c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
        c_starts = (ctypes.c_int64 * n)(*[int(s) for s in starts])
        rc = entry(self._pool, c_paths, c_starts, count, n, row_bytes, out.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise OSError(f"native batch read failed for {paths[-rc - 1]}")
        return out

    def read_batch(self, paths: Sequence[str | Path], starts: Sequence[int], count: int,
                   inner_shape: Sequence[int], dtype=np.float32) -> np.ndarray:
        """Rows [start, start+count) of each file: (len(paths), count,
        *inner_shape).  OSError names the first file that is missing, of
        another row size, or too short."""
        out = np.empty((len(paths), count) + tuple(inner_shape), dtype=dtype)
        row_bytes = int(np.prod(inner_shape)) * out.itemsize
        return self._read(self._lib.npy_read_batch, paths, starts, count, row_bytes, out)

    def read_batch_bf16(self, paths: Sequence[str | Path], starts: Sequence[int], count: int,
                        inner_shape: Sequence[int]) -> np.ndarray:
        """f32 rows [start, start+count) of each file, converted to bfloat16
        in the read pass (RNE, equal to `.to(torch.bfloat16)` and to
        ml_dtypes' cast): the bf16 bits as a uint16 (len(paths), count,
        *inner_shape) array.  A file that is not f32 raises OSError."""
        out = np.empty((len(paths), count) + tuple(inner_shape), dtype=np.uint16)
        row_bytes_f32 = int(np.prod(inner_shape)) * 4
        return self._read(self._lib.npy_read_batch_bf16, paths, starts, count, row_bytes_f32, out)
