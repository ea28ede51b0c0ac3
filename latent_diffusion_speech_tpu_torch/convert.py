"""Flax parameter trees -> state dicts of the port's modules.

Input is a flax tree as nested dicts of numpy arrays
(`jax.tree_util.tree_map(np.asarray, params)`); nothing here imports JAX, so
a tree saved with numpy loads on a machine without it.  The port's modules
name their submodules after the flax tree, so the mapping is by leaf:

* Dense kernel (in, out) -> `weight` (out, in)
* Conv kernel (k, in, out) -> `weight` (out, in, k); a 2-D one
  (kh, kw, in, out) -> (out, in, kh, kw)
* ConvTranspose kernel, stored by the JAX package as the flipped
  input-dilated-conv kernel (k, in, out) -> `weight` (in, out, k)
* LayerNorm / GroupNorm `scale` -> `weight`; Embed `embedding` -> `weight`
* `bias` and other top-level arrays keep their names.

`vq_state_from_jax` carries a learned VQ's state (a `VQState` or its dict)
across as the port's `VQState`.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import re

import numpy as np
import torch

__all__ = ["roformer_from_jax", "unit2mel_from_jax", "encoder_from_jax", "generator_from_jax",
           "whisper_encoder_from_jax", "discriminator_bank_from_jax", "vq_state_from_jax",
           "hubert_from_jax", "wav2vec2_from_jax", "w2vbert_from_jax", "llama_from_jax", "bert_from_jax",
           "vaegan_modules_from_jax"]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _convert(tree: Mapping, is_transposed_conv: Callable[[str], bool] = lambda p: False) -> dict:
    state = {}
    for path, arr in _flatten(tree).items():
        module, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = np.transpose(arr, (3, 2, 0, 1))
            elif is_transposed_conv(module):
                arr = np.transpose(arr[::-1], (1, 2, 0))
            else:
                arr = np.transpose(arr, (2, 1, 0))
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        name = f"{module}.{leaf}" if module else leaf
        state[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return state


def roformer_from_jax(params: Mapping) -> dict:
    """flax `Roformer` params -> state dict of the port's `Roformer`."""
    return _convert(params)


def unit2mel_from_jax(params: Mapping) -> dict:
    """flax `Unit2Mel` params -> state dict of the port's `Unit2Mel`, for
    either denoiser: the flagship's `unet.down_0_res_0...` tree, or the
    general denoiser's `unet.down_blocks_0.resnets_0...` /
    `unet.down_blocks_0.attentions_0.transformer_blocks_0.attn1.to_q` /
    `unet.down_blocks_0.downsamplers_0.conv` tree (`UNet1DCondition` with
    any block types of `Unit2MelConfig.general_unet_config`: the zoo's
    leaves, such as `attentions_0.add_k_proj`, `norm_cross`, `group_norm`,
    `transformers_1`, `resnet_down`, `skip_conv`, `skip_norm`, the
    AdaGroupNorms' `linear`, and the conditioning's `time_proj.weight`,
    `class_embedding`, `add_embedding`, `encoder_hid_proj` and
    `time_embedding.cond_proj`, are all ordinary Dense, conv, norm or
    embedding leaves: none is transposed).  The port's `Unit2Mel` must be
    built with the same `denoiser`."""
    return _convert(params)


def encoder_from_jax(params: Mapping) -> dict:
    """flax HiFi-VAEGAN `VAEEncoder` params -> state dict of the port's
    `VAEEncoder` (every layer an ordinary convolution, `down_*` strided)."""
    return _convert(params)


def generator_from_jax(params: Mapping) -> dict:
    """flax HiFi-VAEGAN `Generator` params -> state dict of the port's
    `Generator` (the `up_*` layers are transposed convolutions)."""
    return _convert(params, is_transposed_conv=lambda m: m.startswith("up_") and "." not in m)


def whisper_encoder_from_jax(params: Mapping) -> dict:
    """flax `WhisperEncoder` params -> state dict of the port's
    `WhisperEncoder`, whose names are the reference checkpoint's:
    `block_{i}` -> `blocks.{i}`, `mlp_0` / `mlp_2` -> `mlp.0` / `mlp.2`."""
    return {re.sub(r"block_(\d+)\.", r"blocks.\1.", k).replace(".mlp_0.", ".mlp.0.").replace(".mlp_2.", ".mlp.2."): v
            for k, v in _convert(params).items()}


def discriminator_bank_from_jax(params: Mapping) -> dict:
    """flax `DiscriminatorBank` params -> state dict of the port's
    `DiscriminatorBank` (the same `Conv_{j}` names; 2-D and grouped 1-D
    kernels moved to torch's layouts)."""
    return _convert(params)


def hubert_from_jax(params: Mapping) -> dict:
    """flax `Hubert` / `HubertSoft` params -> state dict of the port's
    `Hubert` (`masked_spec_embed` keeps its name)."""
    return _convert(params)


def wav2vec2_from_jax(params: Mapping) -> dict:
    """flax `Wav2Vec2Encoder` params -> state dict of the port's `Wav2Vec2Encoder`."""
    return _convert(params)


def w2vbert_from_jax(params: Mapping) -> dict:
    """flax `W2vBertModel` params -> state dict of the port's `W2vBertModel`
    (the depthwise (k, 1, h) kernel to (h, 1, k); each block's
    `self_attn.distance_embedding` keeps its name)."""
    return _convert(params)


def llama_from_jax(params: Mapping) -> dict:
    """flax `Llama` params -> state dict of the port's `Llama`; the MoE banks
    (`block_<i>.moe.gate` (C, E), `w_gate`, `w_up`, `w_down`) keep their
    names and layouts."""
    return _convert(params)


def bert_from_jax(params: Mapping) -> dict:
    """flax `BertEncoderModel` params (either layout) -> state dict of the
    port's `BertEncoderModel`."""
    return _convert(params)


def vaegan_modules_from_jax(params: Mapping) -> dict:
    """flax `WN1D` / `ConvReluNorm1D` params -> state dict of the port's
    module (dilated (k, in, out) kernels to (out, in, k))."""
    return _convert(params)


def vq_state_from_jax(state):
    """A JAX `VQState` (or its `_asdict()`) -> the port's `VQState`, on the
    CPU."""
    from latent_diffusion_speech_tpu_torch.quantize.codebook import VQState

    fields = state if isinstance(state, Mapping) else state._asdict()
    return VQState(**{k: torch.from_numpy(np.array(fields[k], dtype=np.float32)) for k in VQState._fields})
