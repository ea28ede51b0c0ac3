"""Operations and bytes from the configuration's shapes, and the published
peaks they are held against.

The counts depend on the shapes alone, so they stay the same whatever
implements the work: 2 operations per multiply-add of every matrix product
and convolution tap, 4 x Tq x Tkv x width per self-attention (q.k and p.v).
Bytes count each input read once and each output written once.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from lds_bench.reference.acoustic import _unet_blocks, vocoder_spec

# Published dense peaks (NVIDIA's H100 SXM data sheet, at the 700 W limit):
# bf16 tensor-core operations/s and HBM3 bytes/s, by the name
# torch.cuda.get_device_name() gives.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_name)


def bound_s(bytes_moved: float, flops: float, peak: Dict[str, float]) -> Tuple[float, str]:
    """(least seconds the card could take, 'bytes' or 'operations')."""
    t_b, t_f = bytes_moved / peak["hbm_bytes"], flops / peak["bf16_flops"]
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def _block_length(canon: str, T: float, n: int) -> float:
    """Output frames of a canonical UNet block at input length T."""
    p = canon.split(".")
    if p[0] == "down":
        i = int(p[1])
        return T / 2 ** (i + 1) if p[2] == "downsample" else T / 2 ** i
    if p[0] == "mid":
        return T / 2 ** (n - 1)
    if p[0] == "up":
        i = int(p[1])
        return T / 2 ** (n - 2 - i) if p[2] == "upsample" else T / 2 ** (n - 1 - i)
    return T


def _is_time(canon: str, leaf: str) -> bool:
    return canon.startswith("time.") or leaf.startswith("time_emb_proj")


def unet_flops(cfg: dict, B: int, T: float, time_mlp: bool = True) -> float:
    """Operations of one denoiser forward at B x T frames; `time_mlp=False`
    leaves out the time MLP and the resnets' time projections (work the
    fused kernel's caller does before the launch)."""
    n = len(cfg["block_out_channels"])
    total = 0.0
    for canon, kind, shapes in _unet_blocks(cfg):
        L = _block_length(canon, T, n)
        for leaf, shape, k in shapes:
            if k != "w":
                continue
            if _is_time(canon, leaf):
                total += 2 * B * math.prod(shape) if time_mlp else 0
            else:
                total += 2 * B * L * math.prod(shape)
        if kind == "attn":
            c = shapes[0][1][0]
            total += 2 * 4 * B * L * L * c
    return total


def unet_fwd_bytes(cfg: dict, T: int) -> float:
    """Bytes the fused whole-UNet kernel (B=1) must move at T frames: its
    product weights in the served dtype, norm parameters in float32, the
    resnets' scale/shift rows, the input read and the output written."""
    wb = DTYPE_BYTES[cfg["dtype"]]
    total = 0.0
    for canon, _, shapes in _unet_blocks(cfg):
        for leaf, shape, k in shapes:
            if _is_time(canon, leaf):
                if leaf == "time_emb_proj.weight":
                    total += shape[0] * wb  # its output: the scale/shift row
                continue
            total += math.prod(shape) * (wb if k in ("w", "b") else 4)
    total += T * (cfg["out_dims"] + cfg["n_hidden"]) * wb + T * cfg["out_dims"] * wb
    return total


def attention_calls(cfg: dict, B: int, T: int) -> List[Tuple[int, int, int, int]]:
    """(B, frames, heads, head dim) of every self-attention call in one
    denoiser forward at T frames."""
    n = len(cfg["block_out_channels"])
    H = cfg["n_heads"]
    out = []
    for canon, kind, shapes in _unet_blocks(cfg):
        if kind == "attn":
            c = shapes[0][1][0]
            out += [(B, int(_block_length(canon, T, n)), H, c // H)] * 2
    return out


def attention_bound_s(calls, dtype: str, peak: Dict[str, float]) -> float:
    """Least seconds of these attention calls: q, k, v read and the output
    written once, 4 x D operations per (query, key) pair and head."""
    wb = DTYPE_BYTES[dtype]
    total = 0.0
    for B, T, H, D in calls:
        total += bound_s(wb * H * D * 4 * B * T, 4 * B * H * D * T * T, peak)[0]
    return total


def condition_flops(cfg: dict, B: int, T: float) -> float:
    return 2 * B * T * cfg["input_channel"] * cfg["n_hidden"]


def vocoder_flops(vcfg: dict, B: int, T: float) -> float:
    """Operations of the HiFi-VAEGAN generator on B x T latent frames."""
    rates = vcfg["upsample_rates"]
    total = 0.0
    for name, shape, kind in vocoder_spec(vcfg):
        if kind not in ("w", "wt"):
            continue
        head = name.split(".")[0]
        if head == "conv_pre":
            L = T
        elif head == "conv_post":
            L = T * math.prod(rates)
        elif head.startswith("up_"):
            L = T * math.prod(rates[: int(head[3:])])  # a transposed convolution: its input positions
        else:
            L = T * math.prod(rates[: int(head.split("_")[1]) + 1])
        total += 2 * B * L * math.prod(shape)
    return total


def request_flops(cfg: dict, B: int, T: float) -> float:
    """Operations one request needs at its own length: the condition, every
    denoiser evaluation of the sampler and the vocoder."""
    evals = cfg["k_step_max"] // cfg["infer_speedup"]
    return condition_flops(cfg, B, T) + evals * unet_flops(cfg, B, T) + vocoder_flops(cfg["vocoder"], B, T)
