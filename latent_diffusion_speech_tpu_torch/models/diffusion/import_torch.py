"""The reference's diffusion checkpoints (`exp/diffusion/model_<step>.pt`:
Unit2Mel with a diffusers-style `UNet1DConditionModel`) -> state dicts of
the port's `Unit2Mel`.

Counterpart of `latent_diffusion_speech_tpu/models/diffusion/import_torch.py`,
in two steps as `models/vaegan/import_torch.py` set: the `*_params_from_torch`
functions are numpy copies of the JAX importers (the same keys read, the
same flax-layout tree built), and `unit2mel_state_from_torch` passes the
tree through `convert.unit2mel_from_jax`.  So the port reads what JAX
reads:

* `proj_in` / `proj_out` are k=1 convolutions that become Dense layers;
* `conv_shortcut` exists only where a resnet's in and out widths differ;
* the attention's `to_q` / `to_k` / `to_v` have no bias;
* `spk_embed`, `volume_embed` and `aug_shift_embed` (no bias) are optional;
* under `decoder.` only `decoder.denoise_fn.*` is read (the reference's
  GaussianDiffusion buffers are not).

`block_params_from_torch` is the JAX package's path-translating importer
for the general block zoo; its tree goes through `convert.unit2mel_from_jax`
(under `unet`) for every block type and conditioning input of the port's
`UNet1DCondition`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from latent_diffusion_speech_tpu_torch.convert import unit2mel_from_jax
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1DConfig

__all__ = [
    "unet_params_from_torch",
    "unit2mel_params_from_torch",
    "unit2mel_state_from_torch",
    "block_params_from_torch",
]


def _np(v):
    return np.asarray(v.detach().cpu().float().numpy() if hasattr(v, "detach") else v, np.float32)


def _dense(state, name, bias=True):
    p = {"kernel": _np(state[f"{name}.weight"]).T}
    if bias and f"{name}.bias" in state:
        p["bias"] = _np(state[f"{name}.bias"])
    return p


def _conv(state, name):
    w = _np(state[f"{name}.weight"])  # (out, in, k)
    p = {"kernel": np.transpose(w, (2, 1, 0))}
    if f"{name}.bias" in state:
        p["bias"] = _np(state[f"{name}.bias"])
    return p


def _conv1x1_as_dense(state, name):
    w = _np(state[f"{name}.weight"])  # (out, in, 1)
    return {"kernel": w[:, :, 0].T, "bias": _np(state[f"{name}.bias"])}


def _norm(state, name):
    return {"scale": _np(state[f"{name}.weight"]), "bias": _np(state[f"{name}.bias"])}


def _resnet(state, p):
    out = {
        "norm1": _norm(state, f"{p}.norm1"),
        "conv1": _conv(state, f"{p}.conv1"),
        "time_emb_proj": _dense(state, f"{p}.time_emb_proj"),
        "norm2": _norm(state, f"{p}.norm2"),
        "conv2": _conv(state, f"{p}.conv2"),
    }
    if f"{p}.conv_shortcut.weight" in state:
        out["conv_shortcut"] = _conv(state, f"{p}.conv_shortcut")
    return out


def _attention(state, p):
    """Transformer2DModel -> TransformerBlock1D params."""
    tb = f"{p}.transformer_blocks.0"
    return {
        "norm": _norm(state, f"{p}.norm"),
        "proj_in": _conv1x1_as_dense(state, f"{p}.proj_in"),
        "proj_out": _conv1x1_as_dense(state, f"{p}.proj_out"),
        "norm1": _norm(state, f"{tb}.norm1"),
        "attn1": {
            "to_q": _dense(state, f"{tb}.attn1.to_q", bias=False),
            "to_k": _dense(state, f"{tb}.attn1.to_k", bias=False),
            "to_v": _dense(state, f"{tb}.attn1.to_v", bias=False),
            "to_out": _dense(state, f"{tb}.attn1.to_out.0"),
        },
        "norm2": _norm(state, f"{tb}.norm2"),
        "attn2": {
            "to_q": _dense(state, f"{tb}.attn2.to_q", bias=False),
            "to_k": _dense(state, f"{tb}.attn2.to_k", bias=False),
            "to_v": _dense(state, f"{tb}.attn2.to_v", bias=False),
            "to_out": _dense(state, f"{tb}.attn2.to_out.0"),
        },
        "norm3": _norm(state, f"{tb}.norm3"),
        "ff_proj": _dense(state, f"{tb}.ff.net.0.proj"),
        "ff_out": _dense(state, f"{tb}.ff.net.2"),
    }


def unet_params_from_torch(state: Dict, cfg: UNet1DConfig) -> Dict:
    n_blocks = len(cfg.block_out_channels)
    params: Dict = {
        "conv_in": _conv(state, "conv_in"),
        "time_mlp1": _dense(state, "time_embedding.linear_1"),
        "time_mlp2": _dense(state, "time_embedding.linear_2"),
        "conv_norm_out": _norm(state, "conv_norm_out"),
        "conv_out": _conv(state, "conv_out"),
        "mid_res_0": _resnet(state, "mid_block.resnets.0"),
        "mid_res_1": _resnet(state, "mid_block.resnets.1"),
        "mid_attn": _attention(state, "mid_block.attentions.0"),
    }
    rev_attn = list(reversed(cfg.cross_attn))
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block):
            params[f"down_{i}_res_{j}"] = _resnet(state, f"down_blocks.{i}.resnets.{j}")
            if cfg.cross_attn[i]:
                params[f"down_{i}_attn_{j}"] = _attention(state, f"down_blocks.{i}.attentions.{j}")
        if i < n_blocks - 1:
            params[f"down_{i}_downsample"] = {"conv": _conv(state, f"down_blocks.{i}.downsamplers.0.conv")}
        for j in range(cfg.layers_per_block + 1):
            params[f"up_{i}_res_{j}"] = _resnet(state, f"up_blocks.{i}.resnets.{j}")
            if rev_attn[i]:
                params[f"up_{i}_attn_{j}"] = _attention(state, f"up_blocks.{i}.attentions.{j}")
        if i < n_blocks - 1:
            params[f"up_{i}_upsample"] = {"conv": _conv(state, f"up_blocks.{i}.upsamplers.0.conv")}
    return params


def unit2mel_params_from_torch(state: Dict, cfg) -> Dict:
    """Map a reference Unit2Mel state dict (`exp/diffusion/model_<step>.pt`
    ['model']) onto the flax Unit2Mel tree (numpy)."""
    unet_state = {
        k[len("decoder.denoise_fn.") :]: v
        for k, v in state.items()
        if k.startswith("decoder.denoise_fn.")
    }
    params: Dict = {
        "unit_embed": _dense(state, "unit_embed"),
        "unet": unet_params_from_torch(unet_state, cfg.unet_config()),
    }
    if "spk_embed.weight" in state:
        params["spk_embed"] = {"embedding": _np(state["spk_embed.weight"])}
    if "volume_embed.weight" in state:
        params["volume_embed"] = _dense(state, "volume_embed")
    if "aug_shift_embed.weight" in state:
        params["aug_shift_embed"] = _dense(state, "aug_shift_embed", bias=False)
    return params


def unit2mel_state_from_torch(state: Dict, cfg) -> dict:
    """A reference Unit2Mel state dict -> state dict of the port's flagship `Unit2Mel`."""
    return unit2mel_from_jax(unit2mel_params_from_torch(state, cfg))


def block_params_from_torch(state: Dict, template: Dict = None) -> Dict:
    """Generic path-translating importer for the block zoo (`blocks.py`).

    The flax module names mirror the torch submodule paths with list indices
    merged into the parent name (``resnets.0.conv1.weight`` ->
    ``resnets_0/conv1/kernel``), so any reference block state_dict converts
    mechanically:

    * conv  ``weight`` (O, I, k) -> ``kernel`` (k, I, O)
    * linear ``weight`` (O, I)   -> ``kernel`` (I, O)
    * norm  ``weight``  (C,)     -> ``scale``
    * non-param buffers (num_batches_tracked, FIR kernels) are dropped

    `template` (a params tree of the target module) reconciles a torch 1x1
    conv against a torch linear: leaves whose rank disagrees with the
    template are squeezed/expanded along the kernel axis.
    """
    params: Dict = {}
    for key, value in state.items():
        w = _np(value)
        parts = key.split(".")
        leaf = parts[-1]
        path = []
        for p in parts[:-1]:
            if p.isdigit() and path:
                path[-1] = f"{path[-1]}_{p}"
            else:
                path.append(p)
        if leaf == "weight":
            if w.ndim == 3:
                entry = ("kernel", np.transpose(w, (2, 1, 0)))
            elif w.ndim == 2:
                entry = ("kernel", w.T)
            elif w.ndim == 1:
                entry = ("scale", w)
            else:
                continue  # 4-D 2-D-residue buffers: not part of the 1-D intent
        elif leaf == "bias":
            entry = ("bias", w)
        else:
            continue
        name, w = entry
        if template is not None:
            ref = template
            ok = True
            for p in path:
                if not isinstance(ref, dict) or p not in ref:
                    ok = False
                    break
                ref = ref[p]
            if ok and isinstance(ref, dict) and name in ref:
                tgt = ref[name]
                if w.ndim == 3 and getattr(tgt, "ndim", w.ndim) == 2:
                    w = w[0]  # (1, I, O) conv1x1 -> Dense (I, O)
                elif w.ndim == 2 and getattr(tgt, "ndim", w.ndim) == 3:
                    w = w[None]  # linear -> k=1 conv (1, I, O)
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[name] = w
    return params
