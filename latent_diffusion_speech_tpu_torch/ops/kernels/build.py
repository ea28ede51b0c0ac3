"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/*.cu` source compiles in its own `nvcc -c` process, all started
together, and one more `nvcc` links the objects into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds).
The library lands in a build directory keyed by a hash of the sources and
the flags, so an edited source rebuilds and an unchanged one loads the
library already there.  The build runs at the first kernel launch, never at
import: the CPU tests import every module of the package.

The build directory is `<package>/_build/` (listed in `.gitignore`), or
`$LDS_TORCH_BUILD_DIR` when that is set.

`entry` hands a wrapper one of the library's C functions with its ctypes
argument types set once per loaded library, not on every call.  The
attention wrappers pass each launch's arguments as one packed struct
(`struct.Struct.pack`, one ctypes argument, `launch_packed`): converting ~20
Python ints one by one costs several µs a call.  `attention_strides` and
`attention_plan` hold the checks and the launch plan that the K4 and K5
wrappers share.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["load_library", "build_info", "entry", "check_aligned", "attention_strides", "attention_plan",
           "launch_packed", "PACKED_ARGTYPES", "HEAD_DIMS", "BWD_HEAD_DIMS", "CSRC_DIR"]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
HEAD_DIMS = (8, 32, 48, 64)  # the attention forward kernels' head dims (a template parameter each)
BWD_HEAD_DIMS = (32, 48, 64)  # the K4 backward's
PACKED_ARGTYPES = [ctypes.c_char_p]  # a C entry that takes one packed struct

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: dict = {}
_entries: dict = {}  # name -> (library, its function with argtypes set)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def _build_dir() -> Path:
    return Path(os.environ.get("LDS_TORCH_BUILD_DIR", PACKAGE_DIR / "_build"))


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library.

    Raises RuntimeError with nvcc's stderr when the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = _build_dir() / _source_hash()
        so_path = out_dir / "libldstorch_kernels.so"
        log_path = out_dir / "nvcc.log"
        if not so_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
            # one compile per source, all at once, then one link; the library
            # is built under a temporary name and renamed, so a concurrent
            # process never loads a half-written one
            jobs = []
            for src in sorted(CSRC_DIR.glob("*.cu")):
                cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
                       "-o", str(tmp_dir / (src.stem + ".o"))]
                jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                   text=True)))
            # wait for every compile before reporting a failure: no process outlives the call
            log = [proc.communicate()[1] for _, proc in jobs]
            for (cmd, proc), err in zip(jobs, log):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")
            tmp = tmp_dir / so_path.name
            cmd = [_nvcc(), "-shared", "-o", str(tmp), *sorted(str(p) for p in tmp_dir.glob("*.o"))]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
            log_path.write_text("".join(log) + proc.stderr)
            os.replace(tmp, so_path)
            shutil.rmtree(tmp_dir)
            _info.update(built=True, seconds=time.perf_counter() - t0)
        else:
            _info.update(built=False, seconds=0.0)
        _info.update(path=str(so_path), log=log_path.read_text() if log_path.exists() else "")
        _lib = ctypes.CDLL(str(so_path))
        return _lib


def build_info() -> dict:
    """After `load_library`: {'path', 'built', 'seconds', 'log'} (the log
    holds ptxas's register / shared-memory / spill report)."""
    return dict(_info)


def entry(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The library's C function `name`, returning int (a cudaError_t), with
    `argtypes` set the first time it is asked for from this library."""
    lib = load_library()
    hit = _entries.get(name)
    if hit is not None and hit[0] is lib:
        return hit[1]
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    _entries[name] = (lib, fn)
    return fn


def check_aligned(what: str, strides: Sequence[int], pointers: Sequence[int]) -> None:
    """Raise ValueError unless every data pointer and every stride (2-byte
    elements) is a multiple of 16 bytes, as the kernels' 16-byte cp.async
    copies need."""
    if math.gcd(*pointers) % 16 or math.gcd(*strides) % 8:
        raise ValueError(
            f"{what}: bf16 q, k, v need 16-byte aligned data pointers and (b, t, h) strides that are "
            f"multiples of 8 elements, got pointers {[p % 16 for p in pointers]} (mod 16) and strides "
            f"{tuple(strides)}"
        )


def attention_strides(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtypes,
                      head_dims: Sequence[int] = HEAD_DIMS) -> tuple:
    """Check q, k, v (B, T, H, D) of one dtype in `dtypes`, a head dim in
    `head_dims`, one device and a contiguous head dim; return their nine
    (b, t, h) strides in elements.  The caller checks the shapes."""
    dtype = q.dtype
    if dtype not in dtypes or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"{what} takes bf16 or f32, got {q.dtype} {k.dtype} {v.dtype}")
    if q.shape[3] not in head_dims:
        raise ValueError(f"{what}: head dim {q.shape[3]} not in {tuple(head_dims)}")
    if k.get_device() != q.get_device() or v.get_device() != q.get_device():
        raise ValueError(f"{what}: q, k, v on different devices")
    sq, sk, sv = q.stride(), k.stride(), v.stride()
    if sq[3] != 1 or sk[3] != 1 or sv[3] != 1:
        raise ValueError(f"{what}: the head dim must be contiguous (stride 1)")
    return sq[:3] + sk[:3] + sv[:3]


def attention_plan(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, entries: dict) -> Tuple[str, tuple]:
    """`attention_strides`, and for bf16 (the 16-byte cp.async copies)
    `check_aligned`; return (the C entry `entries` gives q's dtype, the
    strides).  Reads no device data, so it runs on tensors of any device."""
    strides = attention_strides(what, q, k, v, entries)
    if q.dtype is torch.bfloat16:
        check_aligned(what, strides, (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    return entries[q.dtype], strides


def launch_packed(name: str, index: int, pack: Callable[[int], bytes]) -> None:
    """Call the C entry `name`, which takes one packed struct, with
    `pack(stream)` for the current stream of CUDA device `index`; raise on a
    CUDA error.  Makes `index` the current device only when it is not."""
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return launch_packed(name, index, pack)
    err = entry(name, PACKED_ARGTYPES)(pack(torch.cuda.current_stream(index).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
