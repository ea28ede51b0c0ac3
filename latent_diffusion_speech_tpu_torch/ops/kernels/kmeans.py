"""K6: nearest codebook row (the k-means snap).

Counterpart of `latent_diffusion_speech_tpu/ops/pallas/kmeans.py::kmeans_argmin`.
`kmeans_argmin` launches the CUDA kernel in `csrc/kmeans_argmin.cu` for
CUDA tensors and runs `kmeans_argmin_plain` for CPU tensors; there is no
other path.  Both compute, in f32, the argmin over K of ||c||^2 - 2 x.c
(the ||x||^2 term does not change the argmin), ties to the lowest index;
the codebook norms are computed here, once per call.  The kernel loads
16-byte vectors when D % 4 == 0 and both operands are 16-byte aligned, and
masked scalars otherwise.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["kmeans_argmin", "kmeans_argmin_plain", "split_codes"]

BLOCK_ROWS = 128   # rows of x per block (BM in the kernel)
BLOCK_CODES = 128  # codes per tile (BN in the kernel)
BLOCKS_PER_SM = 2  # the kernel's __launch_bounds__ minimum
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

# kernel launches since the last reset (chip_smoke.py resets and reads it)
launches = 0


def kmeans_argmin_plain(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """x (N, D), codebook (K, D) -> int32 ids (N,), in f32."""
    cb = codebook.float()
    d = (cb * cb).sum(-1)[None, :] - 2.0 * (x.float() @ cb.T)
    return d.argmin(dim=-1).to(torch.int32)


def split_codes(n_rows: int, n_codes: int, n_sms: int) -> tuple:
    """(splits, codes per split): the code range is cut into contiguous
    splits of whole 128-code tiles until the grid fills one wave of
    BLOCKS_PER_SM blocks per SM (one split when the rows alone fill it):
    4128 rows (33 row tiles) x 4096 codes on 132 SMs -> 8 splits of 512."""
    row_tiles = -(-n_rows // BLOCK_ROWS)
    code_tiles = -(-n_codes // BLOCK_CODES)
    want = min(code_tiles, max(1, -(-BLOCKS_PER_SM * n_sms // row_tiles)))
    per = -(-code_tiles // want) * BLOCK_CODES
    return -(-n_codes // per), per


def kmeans_argmin(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook ids (N,) int32 for x (N, D) f32 against codebook
    (K, D) f32: the kernel for CUDA tensors, the plain version for CPU."""
    global launches
    if x.device.type == "cpu":
        return kmeans_argmin_plain(x, codebook)
    if x.device.type != "cuda":
        raise RuntimeError(f"kmeans_argmin: no kernel for device {x.device}")
    if x.dim() != 2 or codebook.dim() != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(f"x (N, D) and codebook (K, D) with the same D: {x.shape} {codebook.shape}")
    if x.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"kmeans_argmin takes f32, got {x.dtype} {codebook.dtype}")
    if codebook.device != x.device:
        raise ValueError("x and codebook on different devices")
    x, codebook = x.contiguous(), codebook.contiguous()
    from latent_diffusion_speech_tpu_torch.ops.kernels.build import entry

    N, D = x.shape
    K = codebook.shape[0]
    ids = torch.empty((N,), dtype=torch.int32, device=x.device)
    if N == 0:
        return ids
    if K == 0:
        raise ValueError("kmeans_argmin: empty codebook")
    cb_sq = (codebook * codebook).sum(-1)
    splits, per = split_codes(N, K, torch.cuda.get_device_properties(x.device).multi_processor_count)
    part_d = torch.empty((splits, N), dtype=torch.float32, device=x.device)
    part_i = torch.empty((splits, N), dtype=torch.int32, device=x.device)
    vec = int(D % 4 == 0 and x.data_ptr() % 16 == 0 and codebook.data_ptr() % 16 == 0)
    fn = entry("kmeans_argmin_f32", ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), codebook.data_ptr(), cb_sq.data_ptr(), part_d.data_ptr(),
                 part_i.data_ptr(), ids.data_ptr(), N, K, D, splits, per, vec, stream)
    if err != 0:
        raise RuntimeError(f"kmeans_argmin launch failed: cudaError {err}")
    launches += 1
    return ids
