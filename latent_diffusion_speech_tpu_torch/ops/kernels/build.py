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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["load_library", "build_info", "CSRC_DIR"]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: dict = {}


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
