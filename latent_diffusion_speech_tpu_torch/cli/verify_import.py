"""Import-and-verify any reference checkpoint in one command.

Counterpart of `latent_diffusion_speech_tpu/cli/verify_import.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.verify_import <ckpt> [--kind auto] [--device cpu]

It (1) detects the artifact kind from the checkpoint's key fingerprint,
(2) infers the geometry from the state dict itself (layer counts, widths,
vocab sizes, not defaults), (3) runs the port's importer and reports key
coverage (torch keys never read) and parameter-element accounting,
(4) runs a deterministic forward in f32 (TF32 off) on the device (`cuda`
unless `--device` says otherwise) and reports output stats and
finiteness, and (5) optionally compares against / writes a golden npz:

    --save-golden g.npz   capture {inputs, output} from this import
    --golden g.npz        compare this import's forward to a saved capture

Each forward draws its inputs from `np.random.default_rng(0)` in the JAX
CLI's order and shapes, so a golden written by either package's CLI is a
golden for the other's.  The kinds `whisper`, `vaegan-encoder`,
`vaegan-decoder` (and a directory holding the pair), `unit2mel` (through
`infer/load.py::load_reference_pipeline`, f32), `roformer` and `codebook`
(K6 on the card) run a forward; the unit encoders `hubert` (bshall's
layout, under a `hubert` or `model` key or bare), `wav2vec2` (HF's or
fairseq's) and `w2vbert` (HF's) are imported at the layer counts their
state dicts hold (the JAX CLI assumes the published ones) and report, as
the JAX CLI does, the mean |x| of the first eight leaves of the
imported tree in JAX's leaf order (`_verify_stats_only`); `llama` runs
the Llama's forward (geometry from the state dict, heads from `--heads`,
default 4), and `bert` is imported at the geometry its state dict holds
(the post-LN layout, as the JAX CLI assumes) and reports the same leaf
statistics.

Exit code 0 = imported, forward finite, golden (if given) within tolerance.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from typing import Any, Dict

import numpy as np

__all__ = ["verify", "detect_kind", "main"]


# ---------------------------------------------------------------------------
# state-dict access tracking (key coverage)
# ---------------------------------------------------------------------------


class _Tracking(dict):
    """Dict recording which keys were read via __getitem__.

    An importer that iterates `items()` (a prefix strip, a weight-norm fold)
    transforms the whole dict: per-key coverage is then reported as not
    trackable (None)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.read: set = set()
        self.bulk_read = False

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def items(self):
        self.bulk_read = True
        return super().items()


def _coverage(report: Dict, tracking: _Tracking) -> None:
    report["torch_keys_read"] = len(tracking.read)
    if tracking.bulk_read:
        report["torch_keys_unused"] = None
    else:
        report["torch_keys_unused"] = sorted(set(tracking) - tracking.read)[:20]


def _to_np(v):
    return np.asarray(v.detach().cpu().float().numpy() if hasattr(v, "detach") else v)


def _n_elements(state) -> int:
    """Elements of an imported state dict (the JAX tree's leaves, one for one)."""
    return int(sum(np.size(_to_np(v)) for v in state.values()))


def _max_index(state: Dict, pattern: str) -> int:
    """Highest integer N over keys matching `pattern` (one group)."""
    rx = re.compile(pattern)
    best = -1
    for k in state:
        m = rx.match(k)
        if m:
            best = max(best, int(m.group(1)))
    return best


def _state(obj):
    return obj.get("model", obj) if isinstance(obj, dict) else obj


# ---------------------------------------------------------------------------
# kind detection
# ---------------------------------------------------------------------------


def detect_kind(obj: Any, path: Path) -> str:
    """Fingerprint the checkpoint layout -> artifact kind."""
    if isinstance(obj, dict) and "cluster_centers_" in obj:
        return "codebook"
    if hasattr(obj, "cluster_centers_"):
        return "codebook"
    if isinstance(obj, dict) and "dims" in obj and "model_state_dict" in obj:
        return "whisper"
    state = _state(obj)
    if not isinstance(state, dict):
        raise ValueError(f"{path}: unrecognized checkpoint object {type(obj)}")
    keys = list(state.keys())

    def has(prefix):
        return any(k.startswith(prefix) for k in keys)

    if has("text_encoder.") and has("semantic_decoder."):
        return "roformer"
    if has("llama.model.layers.") or has("model.layers."):
        return "llama"
    if has("unit_embed.") and has("decoder."):
        return "unit2mel"
    if has("conv1.") and has("blocks.0.attn."):
        return "whisper"  # bare encoder state dict without the dims wrapper
    if has("feature_extractor.conv_layers.") and has("encoder.layers.0.attention."):
        return "hubert"
    if has("wav2vec2.") or (has("feature_projection.") and has("encoder.pos_conv_embed.")):
        return "wav2vec2"
    if has("encoder.layers.0.conv_module.") or has("w2v_bert."):
        return "w2vbert"
    if has("embeddings.word_embeddings.") and has("encoder.layer.0.attention.self.query."):
        return "bert"
    if has("ups.0.") and has("conv_pre."):
        # HiFi-VAEGAN: the encoder's conv_pre reads raw audio (1 channel),
        # the generator's the latent (inter_channels)
        w = None
        for cand in ("conv_pre.weight", "conv_pre.weight_v"):
            if cand in state:
                w = _to_np(state[cand])
                break
        if w is not None and w.shape[1] == 1:
            return "vaegan-encoder"
        return "vaegan-decoder"
    raise ValueError(
        f"{path}: cannot detect checkpoint kind from keys like {keys[:5]}; "
        "pass --kind explicitly"
    )


# ---------------------------------------------------------------------------
# per-kind verify: (import, forward, inputs)
# ---------------------------------------------------------------------------


def _verify_codebook(obj, report, args, device):
    import torch

    from latent_diffusion_speech_tpu_torch.quantize.kmeans import kmeans_predict, load_codebook

    centroids = load_codebook(args.path)
    report["geometry"] = {"clusters": centroids.shape[0], "dim": centroids.shape[1]}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, centroids.shape[1])).astype(np.float32)
    ids = kmeans_predict(torch.from_numpy(x).to(device), torch.from_numpy(centroids).to(device))
    return {"x": x}, ids.cpu().numpy().astype(np.int64), {"cluster_centers_": centroids}


def _verify_whisper(obj, report, args, device):
    import torch

    from latent_diffusion_speech_tpu_torch.models.units import whisper_state_from_reference
    from latent_diffusion_speech_tpu_torch.models.whisper.model import WhisperDims, WhisperEncoder

    if isinstance(obj, dict) and "dims" in obj:
        dims = WhisperDims.from_checkpoint_dims(obj["dims"])
        state = obj["model_state_dict"]
    else:
        state = _state(obj)
        strip = {
            (k[len("encoder."):] if k.startswith("encoder.") else k): v
            for k, v in state.items()
        }
        w = _to_np(strip["conv1.weight"])  # (n_state, n_mels, 3)
        dims = WhisperDims(
            n_mels=w.shape[1],
            n_audio_state=w.shape[0],
            n_audio_ctx=_to_np(strip["positional_embedding"]).shape[0]
            if "positional_embedding" in strip
            else 1500,
            n_audio_head=args.heads or max(w.shape[0] // 64, 1),
            n_audio_layer=_max_index(strip, r"blocks\.(\d+)\.") + 1,
        )
    tracking = _Tracking(state)
    imported = whisper_state_from_reference(tracking)
    report["geometry"] = dims.__dict__
    _coverage(report, tracking)

    module = WhisperEncoder(dims)
    module.load_state_dict({k: torch.as_tensor(_to_np(v), dtype=torch.float32) for k, v in imported.items()})
    module = module.to(device).eval()
    rng = np.random.default_rng(0)
    T = min(200, 2 * dims.n_audio_ctx)  # stride-2 convs -> T/2 <= n_ctx outputs
    mel = rng.standard_normal((1, dims.n_mels, T)).astype(np.float32)
    with torch.no_grad():
        out = module(torch.from_numpy(mel).to(device)).float().cpu().numpy()
    return {"mel": mel}, out, imported


def _verify_vaegan(obj, report, args, kind, device):
    import torch

    from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
    from latent_diffusion_speech_tpu_torch.models.vaegan.import_torch import (
        encoder_state_from_torch,
        generator_state_from_torch,
    )
    from latent_diffusion_speech_tpu_torch.models.vaegan.models import Generator, VAEEncoder

    h = obj.get("config") if isinstance(obj, dict) else None
    cfg = VAEGANConfig.from_torch_h(h) if h else VAEGANConfig()
    report["geometry"] = {
        "inter_channels": cfg.inter_channels,
        "upsample_rates": list(cfg.upsample_rates),
        "resblock": cfg.resblock,
        "from_checkpoint_config": bool(h),
    }
    state = _state(obj)
    rng = np.random.default_rng(0)
    if kind == "vaegan-encoder":
        imported = encoder_state_from_torch(state, cfg)
        module = VAEEncoder(cfg)
        module.load_state_dict(imported)
        module = module.to(device).eval()
        audio = (0.1 * rng.standard_normal((1, cfg.hop_size * 8))).astype(np.float32)
        with torch.no_grad():
            _, m, logs = module(torch.from_numpy(audio).to(device), sample=False)
        out = torch.cat([m, logs], dim=-1).cpu().numpy()
        return {"audio": audio}, out, imported
    imported = generator_state_from_torch(state, cfg)
    module = Generator(cfg)
    module.load_state_dict(imported)
    module = module.to(device).eval()
    z = rng.standard_normal((1, 8, cfg.inter_channels)).astype(np.float32)
    with torch.no_grad():
        out = module(torch.from_numpy(z).to(device)).cpu().numpy()
    return {"z": z}, out, imported


def _verify_unit2mel(obj, report, args, device):
    import torch

    from latent_diffusion_speech_tpu_torch.infer.load import load_reference_pipeline

    # the config.yaml beside the checkpoint carries the geometry
    pipe = load_reference_pipeline(args.path, dtype=torch.float32, device=device)
    module = pipe.diffusion.module
    cfg = pipe.diffusion.cfg
    report["geometry"] = {
        "input_channel": cfg.input_channel,
        "out_dims": cfg.out_dims,
        "block_out_channels": list(cfg.block_out_channels),
        "n_hidden": cfg.n_hidden,
    }
    rng = np.random.default_rng(0)
    B, T = 1, 64
    units = rng.standard_normal((B, T, cfg.input_channel)).astype(np.float32)
    x_t = rng.standard_normal((B, T, cfg.out_dims)).astype(np.float32)
    t = np.asarray([10], np.int32)
    spk = np.ones((B, 1), np.int32)
    with torch.no_grad():
        cond = module.condition(torch.from_numpy(units).to(device), None,
                                torch.from_numpy(spk).long().to(device), None)
        x = torch.cat([torch.from_numpy(x_t).to(device), cond.float()], dim=-1)
        out = module.denoise(x, torch.from_numpy(t).long().to(device)).float().cpu().numpy()
    return {"units": units, "x_t": x_t, "t": t, "spk": spk}, out, module.state_dict()


def _verify_roformer(obj, report, args, device):
    import torch

    from latent_diffusion_speech_tpu_torch.models.lm.import_hf import roformer_state_from_torch
    from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig

    state = _state(obj)
    # geometry from the state dict itself
    enc_layers = _max_index(state, r"text_encoder\.encoder\.layer\.(\d+)\.") + 1
    dec_layers = _max_index(state, r"semantic_decoder\.roformer\.encoder\.layer\.(\d+)\.") + 1
    enc_h = _to_np(state["text_encoder.embeddings.word_embeddings.weight"]).shape[1]
    dec_emb = _to_np(state["semantic_decoder.roformer.embeddings.word_embeddings.weight"])
    enc_ff = _to_np(state["text_encoder.encoder.layer.0.intermediate.dense.weight"]).shape[0]
    dec_ff = _to_np(state["semantic_decoder.roformer.encoder.layer.0.intermediate.dense.weight"]).shape[0]
    n_spk = (_to_np(state["spk_emb.weight"]).shape[0] - 1) if "spk_emb.weight" in state else 0
    cfg = RoformerConfig(
        encoder=StackConfig(hidden_size=enc_h, num_hidden_layers=enc_layers, intermediate_size=enc_ff,
                            num_attention_heads=args.heads or 8),
        decoder=StackConfig(hidden_size=dec_emb.shape[1], num_hidden_layers=dec_layers,
                            intermediate_size=dec_ff, num_attention_heads=args.heads or 8),
        semantic_kmeans_num=dec_emb.shape[0] - 3,
        n_spk=n_spk,
    )
    report["geometry"] = {
        "encoder_layers": enc_layers, "decoder_layers": dec_layers,
        "hidden": enc_h, "semantic_kmeans_num": cfg.semantic_kmeans_num,
        "n_spk": n_spk,
    }
    tracking = _Tracking(state)
    imported = roformer_state_from_torch(tracking, cfg)
    _coverage(report, tracking)

    system = RoformerSystem(cfg, state_dict=imported, device=device)
    rng = np.random.default_rng(0)
    B, L, S = 1, 12, 16
    phone = rng.integers(1, 40, (B, L)).astype(np.int32)
    tone = rng.integers(0, 5, (B, L)).astype(np.int32)
    sem = rng.integers(0, min(64, cfg.semantic_kmeans_num), (B, S)).astype(np.int32)
    spk = np.ones((B, L), np.int32) if n_spk else None

    def on(a):
        return torch.from_numpy(a).long().to(device)

    with torch.no_grad():
        out = system.module(on(phone), on(tone), on(sem), on(spk) if spk is not None else None)
    return {"phone": phone, "tone": tone, "semantic": sem}, out.float().cpu().numpy(), imported


def _verify_llama(obj, report, args, device):
    import torch

    from latent_diffusion_speech_tpu_torch.models.lm.import_hf import llama_state_from_torch
    from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaConfig, LlamaSystem
    from latent_diffusion_speech_tpu_torch.text.symbols import symbols

    state = _state(obj)
    pre = "llama." if any(k.startswith("llama.") for k in state) else ""
    layers = _max_index(state, (r"llama\." if pre else "") + r"model\.layers\.(\d+)\.") + 1
    emb = _to_np(state[f"{pre}model.embed_tokens.weight"])
    ff = _to_np(state[f"{pre}model.layers.0.mlp.gate_proj.weight"]).shape[0]
    cfg = LlamaConfig(
        hidden_size=emb.shape[1],
        num_hidden_layers=layers,
        intermediate_size=ff,
        num_attention_heads=args.heads or 4,
        semantic_kmeans_num=emb.shape[0] - len(symbols) - 3,
    )
    report["geometry"] = {
        "layers": layers, "hidden": emb.shape[1], "intermediate": ff,
        "vocab": emb.shape[0], "semantic_kmeans_num": cfg.semantic_kmeans_num,
    }
    tracking = _Tracking(state)
    imported = llama_state_from_torch(tracking, cfg)
    _coverage(report, tracking)

    system = LlamaSystem(cfg, state_dict=imported, device=device)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    with torch.no_grad():
        out = system.module(torch.from_numpy(ids).long().to(device))[0]
    return {"input_ids": ids}, out.float().cpu().numpy(), imported


def _leaves(tree: Dict) -> list:
    """The leaves of a nested dict in `jax.tree_util.tree_leaves` order
    (keys sorted at every level)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _verify_stats_only(obj, report, args, kind):
    """Import-only verification of the unit encoders and BERT (their
    forwards are held to HF and the JAX package by the tests): the output is the mean
    |x| of the first eight leaves of the imported tree, as the JAX CLI
    reports them.  The importers read the layer counts from the state
    dict, so a checkpoint of the published geometry gives the JAX CLI's
    numbers."""
    from latent_diffusion_speech_tpu_torch import convert

    state = obj.get("model", obj) if isinstance(obj, dict) else obj
    if kind == "hubert":
        from latent_diffusion_speech_tpu_torch.models.hubert import hubert_params_from_torch

        params = hubert_params_from_torch(obj.get("hubert", state) if isinstance(obj, dict) else state)
        imported = convert.hubert_from_jax(params)
    elif kind == "wav2vec2":
        from latent_diffusion_speech_tpu_torch.models.wav2vec2 import (
            Wav2Vec2Config,
            wav2vec2_params_from_fairseq,
            wav2vec2_params_from_hf,
        )

        cfg = Wav2Vec2Config(
            num_hidden_layers=_max_index(state, r"encoder\.layers\.(\d+)\.") + 1,
            conv_dim=(512,) * (_max_index(state, r"feature_extractor\.conv_layers\.(\d+)\.") + 1))
        report["geometry"] = {"layers": cfg.num_hidden_layers, "convs": len(cfg.conv_dim),
                              "hidden": int(_to_np(state["encoder.layer_norm.weight"]).shape[0])}
        if any(k.startswith("w2v_encoder.") or k.startswith("encoder.layers.0.self_attn") for k in state):
            params = wav2vec2_params_from_fairseq(state, cfg)
        else:
            params = wav2vec2_params_from_hf(state, cfg)
        imported = convert.wav2vec2_from_jax(params)
    elif kind == "bert":
        from latent_diffusion_speech_tpu_torch.models.bert import BertConfig, bert_params_from_torch

        emb = _to_np(state["embeddings.word_embeddings.weight"])
        layers = _max_index(state, r"encoder\.layer\.(\d+)\.") + 1
        cfg = BertConfig(vocab_size=emb.shape[0], hidden_size=emb.shape[1], num_hidden_layers=layers)
        report["geometry"] = {"vocab": emb.shape[0], "hidden": emb.shape[1], "layers": layers}
        params = bert_params_from_torch(state, cfg)
        imported = convert.bert_from_jax(params)
    else:
        from latent_diffusion_speech_tpu_torch.models.w2vbert import W2vBertConfig, w2vbert_params_from_torch

        cfg = W2vBertConfig(num_hidden_layers=_max_index(state, r"encoder\.layers\.(\d+)\.") + 1)
        report["geometry"] = {"layers": cfg.num_hidden_layers,
                              "hidden": int(_to_np(state["feature_projection.projection.weight"]).shape[0])}
        params = w2vbert_params_from_torch(state, cfg)
        imported = convert.w2vbert_from_jax(params)
    out = np.asarray([float(np.abs(np.asarray(x)).mean()) for x in _leaves(params)[:8]])
    return {}, out, imported


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def verify(args) -> Dict:
    """The report of one artifact (`args`: the CLI's namespace; `device`
    None means `cuda`, resolved before anything is read)."""
    from latent_diffusion_speech_tpu_torch.ops.layers import no_tf32, resolve_device

    device = resolve_device(getattr(args, "device", None))
    no_tf32()  # f32 products and convolutions, as the JAX CLI computes
    path = Path(args.path)
    report: Dict = {"path": str(path)}

    obj: Any
    if path.is_dir() and (path / "decoder.pth").exists():
        # a HiFi-VAEGAN pair directory: verify both halves
        enc_args = argparse.Namespace(**{**vars(args), "path": str(path / "encoder.pth")})
        dec_args = argparse.Namespace(**{**vars(args), "path": str(path / "decoder.pth")})
        return {"encoder": verify(enc_args), "decoder": verify(dec_args)}
    if path.suffix == ".npz":
        obj = dict(np.load(path, allow_pickle=True))
    else:
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=False)

    kind = args.kind if args.kind != "auto" else detect_kind(obj, path)
    report["kind"] = kind

    if kind == "codebook":
        inputs, out, imported = _verify_codebook(obj, report, args, device)
    elif kind == "whisper":
        inputs, out, imported = _verify_whisper(obj, report, args, device)
    elif kind in ("vaegan-encoder", "vaegan-decoder"):
        inputs, out, imported = _verify_vaegan(obj, report, args, kind, device)
    elif kind == "unit2mel":
        inputs, out, imported = _verify_unit2mel(obj, report, args, device)
    elif kind == "roformer":
        inputs, out, imported = _verify_roformer(obj, report, args, device)
    elif kind == "llama":
        inputs, out, imported = _verify_llama(obj, report, args, device)
    elif kind in ("hubert", "wav2vec2", "w2vbert", "bert"):
        inputs, out, imported = _verify_stats_only(obj, report, args, kind)
    else:
        raise ValueError(f"unknown kind {kind!r}")

    # element accounting: imported weights against the torch state (weight
    # norm's folding drops the per-channel g magnitudes; embeddings may add
    # rows): the report states both numbers, not a verdict
    state = _state(obj)
    if isinstance(state, dict) and all(hasattr(v, "shape") or hasattr(v, "detach") for v in state.values()):
        report["torch_elements"] = int(sum(int(np.prod(_to_np(v).shape)) for v in state.values()))
    report["imported_elements"] = _n_elements(imported)

    report["output_shape"] = list(np.asarray(out).shape)
    report["output_mean"] = float(np.mean(out))
    report["output_std"] = float(np.std(out))
    report["output_finite"] = bool(np.all(np.isfinite(out)))

    if args.save_golden:
        np.savez(args.save_golden, kind=kind, output=out, **{f"in_{k}": v for k, v in inputs.items()})
        report["golden_saved"] = args.save_golden
    if args.golden:
        g = np.load(args.golden, allow_pickle=True)
        ref = np.asarray(g["output"])
        if ref.shape != np.asarray(out).shape:
            report["golden_match"] = False
            report["golden_error"] = f"shape {list(ref.shape)} != {list(np.asarray(out).shape)}"
        else:
            diff = float(np.max(np.abs(ref - out)))
            denom = float(np.max(np.abs(ref))) or 1.0
            report["golden_max_abs_diff"] = diff
            report["golden_rel_diff"] = diff / denom
            report["golden_match"] = bool(diff / denom <= args.tol)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", help="checkpoint file (.pt/.pth/.npz) or HiFi-VAEGAN dir")
    ap.add_argument("--kind", default="auto", choices=[
        "auto", "whisper", "vaegan-encoder", "vaegan-decoder", "unit2mel",
        "roformer", "llama", "codebook", "hubert", "wav2vec2", "w2vbert", "bert",
    ])
    ap.add_argument("--heads", type=int, default=0,
                    help="attention heads when not inferable from the state dict")
    ap.add_argument("--golden", default=None, help="npz with a trusted {inputs, output}")
    ap.add_argument("--save-golden", default=None, help="write this import's forward as npz")
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="max relative diff accepted vs --golden")
    ap.add_argument("--json", action="store_true", help="machine-readable output only")
    ap.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    report = verify(args)
    print(json.dumps(report, indent=None if args.json else 2, default=str))

    def failed(r):
        if "encoder" in r and "decoder" in r:
            return failed(r["encoder"]) or failed(r["decoder"])
        return (not r.get("output_finite", True)) or r.get("golden_match") is False

    return 1 if failed(report) else 0


if __name__ == "__main__":
    sys.exit(main())
