"""Reference PyTorch HiFi-VAEGAN checkpoints -> state dicts of the port's modules.

Counterpart of `latent_diffusion_speech_tpu/models/vaegan/import_torch.py`
for the encoder and the generator.  The reference saves `encoder.pth` /
`decoder.pth`, each `{"model": state_dict, "config": h}`, with weight norm
on every convolution (`<name>.weight_v` / `<name>.weight_g`).  Here the
norm is folded (W = g * v / ||v||, the norm over every axis but the first,
`torch.nn.utils.weight_norm`'s default) and the names move onto the port's
flax-style tree:

* `conv_pre`, `conv_post` keep their names;
* `ups.{i}` -> `down_{i}` (encoder, strided `Conv1d`) or `up_{i}`
  (generator, `ConvTranspose1d`; torch's own (in, out, k) layout, so no
  tap flip as the flax importer needs);
* `resblocks.{i * n + j}.convs1.{m}` / `.convs2.{m}` -> `res_{i}_{j}.conv1_{m}` /
  `.conv2_{m}` (ResBlock1), `.convs.{m}` -> `.conv_{m}` (ResBlock2).

A missing bias becomes zeros, as in the JAX importer.  The discriminators'
importer waits for codec training (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["fold_weight_norm", "encoder_state_from_torch", "generator_state_from_torch"]


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t, dtype=np.float32)


def fold_weight_norm(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold every `<name>.weight_v`/`<name>.weight_g` pair into `<name>.weight`."""
    out: Dict[str, np.ndarray] = {}
    for key, val in state.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            base = key[: -len(".weight_v")]
            v = _np(val)
            g = _np(state[base + ".weight_g"])
            norm = np.sqrt(np.sum(v.reshape(v.shape[0], -1) ** 2, axis=1)).reshape(
                (-1,) + (1,) * (v.ndim - 1)
            )
            out[base + ".weight"] = g * v / np.maximum(norm, 1e-12)
        else:
            out[key] = _np(val)
    return out


def _layer(state: Dict[str, np.ndarray], src: str, dst: str, out_axis: int) -> Dict[str, torch.Tensor]:
    w = state[src + ".weight"]
    b = state.get(src + ".bias", np.zeros(w.shape[out_axis], np.float32))
    return {dst + ".weight": torch.from_numpy(np.ascontiguousarray(w)), dst + ".bias": torch.from_numpy(b)}


def _stack(state: Dict[str, np.ndarray], cfg, stage: str, transposed: bool) -> dict:
    out = {**_layer(state, "conv_pre", "conv_pre", 0), **_layer(state, "conv_post", "conv_post", 0)}
    n_kernels = len(cfg.resblock_kernel_sizes)
    convs = (("convs1", "conv1"), ("convs2", "conv2")) if cfg.resblock == "1" else (("convs", "conv"),)
    for i in range(len(cfg.upsample_rates)):
        out.update(_layer(state, f"ups.{i}", f"{stage}_{i}", 1 if transposed else 0))
        for j in range(n_kernels):
            src, dst = f"resblocks.{i * n_kernels + j}", f"res_{i}_{j}"
            for theirs, mine in convs:
                for m in range(len(cfg.resblock_dilation_sizes[j])):
                    out.update(_layer(state, f"{src}.{theirs}.{m}", f"{dst}.{mine}_{m}", 0))
    return out


def encoder_state_from_torch(state: Dict, cfg) -> dict:
    """Reference `Encoder` state dict -> state dict of the port's `VAEEncoder`."""
    return _stack(fold_weight_norm(state), cfg, "down", transposed=False)


def generator_state_from_torch(state: Dict, cfg) -> dict:
    """Reference `Generator` state dict -> state dict of the port's `Generator`."""
    return _stack(fold_weight_norm(state), cfg, "up", transposed=True)
