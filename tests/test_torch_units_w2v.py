"""XLSR-53 and w2v-BERT 2.0 in the port against the JAX package and HF.

f32 on the CPU at tiny HF configs (2 layers, C = 64), inputs made with
numpy from a seed.  Weights go across through `convert.py` (the JAX
module's seeded tree) and through each importer from a torch state dict
built here: HF's `Wav2Vec2Model` and its fairseq renaming, HF's
`Wav2Vec2BertModel`.  Tolerances are the JAX package's own parity ones:
2e-4 for both encoders (5e-4 for w2v-BERT through `UnitsEncoder.encode`),
the fbank 2e-4 against JAX's, the mel filters 1e-6.  HuBERT-soft, the
seeded full-width builds and stage 10 are in tests/test_torch_units_alt.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models import w2vbert as j_w2vbert
from latent_diffusion_speech_tpu.models import wav2vec2 as j_wav2vec2
from latent_diffusion_speech_tpu.models.units import UnitsEncoder as JUnitsEncoder
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.models import w2vbert, wav2vec2
from latent_diffusion_speech_tpu_torch.models.units import UnitsEncoder, Wav2Vec2BertUnits, XLSRUnits

XLSR_TOL, W2VBERT_TOL = (2e-4, 2e-4), (2e-4, 2e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=tol[0], rtol=tol[1])


# -- XLSR-53 -------------------------------------------------------------------

def _hf_wav2vec2(seed=0):
    from transformers import Wav2Vec2Config as HFConfig
    from transformers import Wav2Vec2Model

    torch.manual_seed(seed)
    cfg = HFConfig(hidden_size=64, num_hidden_layers=2, intermediate_size=128, num_attention_heads=4,
                   conv_dim=[32, 32, 32], conv_kernel=[10, 3, 2], conv_stride=[5, 2, 2], conv_bias=True,
                   num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, do_stable_layer_norm=True,
                   feat_extract_norm="layer", hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                   feat_proj_dropout=0.0, final_dropout=0.0, layerdrop=0.0, apply_spec_augment=False)
    return Wav2Vec2Model(cfg).eval()


def _fairseq_names(hf_state):
    """HF's names back to fairseq's (tests/test_wav2vec2.py's inverse)."""
    out = {}
    for k, v in hf_state.items():
        fk = k
        if k.startswith("feature_extractor.conv_layers."):
            parts = k.split(".")
            i, rest = parts[2], ".".join(parts[3:])
            if rest.startswith("conv."):
                fk = f"feature_extractor.conv_layers.{i}.0.{rest[5:]}"
            elif rest.startswith("layer_norm."):
                fk = f"feature_extractor.conv_layers.{i}.2.1.{rest[11:]}"
        elif k.startswith("feature_projection.projection."):
            fk = k.replace("feature_projection.projection", "post_extract_proj")
        elif k.startswith("feature_projection.layer_norm."):
            fk = k.replace("feature_projection.layer_norm.", "layer_norm.")
        elif k.startswith("encoder.pos_conv_embed.conv"):
            fk = k.replace("encoder.pos_conv_embed.conv", "encoder.pos_conv.0")
        elif k.startswith("encoder.layers."):
            fk = (k.replace(".attention.", ".self_attn.").replace(".layer_norm.", ".self_attn_layer_norm.")
                  .replace(".feed_forward.intermediate_dense", ".fc1").replace(".feed_forward.output_dense", ".fc2"))
        out[fk] = v
    out["quantizer.vars"] = torch.zeros(1)  # a pretraining head: dropped
    return out


@pytest.mark.parametrize("layout", ["hf", "fairseq"])
def test_xlsr_from_each_layout_matches_jax_and_hf(layout):
    hf = _hf_wav2vec2()
    cfg, jcfg = wav2vec2.Wav2Vec2Config.from_hf(hf.config), j_wav2vec2.Wav2Vec2Config.from_hf(hf.config)
    state = hf.state_dict() if layout == "hf" else _fairseq_names(hf.state_dict())
    fn = "wav2vec2_params_from_hf" if layout == "hf" else "wav2vec2_params_from_fairseq"
    mine, theirs = getattr(wav2vec2, fn)(state, cfg), getattr(j_wav2vec2, fn)(state, jcfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, mine, theirs)
    port = wav2vec2.Wav2Vec2Encoder(cfg)
    port.load_state_dict(wav2vec2.wav2vec2_state_from_torch(state, cfg))
    wav = (np.random.default_rng(0).standard_normal((2, 3200)) * 0.1).astype(np.float32)
    jm = j_wav2vec2.Wav2Vec2Encoder(jcfg)
    ref = jax.jit(lambda p, w: jm.apply({"params": p}, w))(jax.tree_util.tree_map(jnp.asarray, theirs),
                                                          jnp.asarray(wav))
    normed = (wav - wav.mean(-1, keepdims=True)) / np.sqrt(wav.var(-1, keepdims=True) + 1e-7)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(wav))
        oracle = hf(input_values=torch.from_numpy(normed)).last_hidden_state
    _close(got, ref, XLSR_TOL)
    _close(got, oracle, XLSR_TOL)


def test_xlsr_seeded_tree_converts():
    jcfg = j_wav2vec2.Wav2Vec2Config(hidden_size=64, num_hidden_layers=2, intermediate_size=128,
                                     num_attention_heads=4, conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2),
                                     conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                                     num_conv_pos_embedding_groups=4)
    wav = (np.random.default_rng(2).standard_normal((1, 4000)) * 0.1).astype(np.float32)
    jm = j_wav2vec2.Wav2Vec2Encoder(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(wav))["params"]
    port = wav2vec2.Wav2Vec2Encoder(wav2vec2.Wav2Vec2Config(**{k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__}))
    port.load_state_dict(convert.wav2vec2_from_jax(_np_tree(params)))
    with torch.no_grad():
        _close(port.eval()(torch.from_numpy(wav)), jax.jit(jm.apply)({"params": params}, jnp.asarray(wav)), XLSR_TOL)


# -- w2v-BERT 2.0 ----------------------------------------------------------------

def _hf_w2vbert(seed=0):
    from transformers import Wav2Vec2BertConfig, Wav2Vec2BertModel

    torch.manual_seed(seed)
    cfg = Wav2Vec2BertConfig(hidden_size=64, num_hidden_layers=2, intermediate_size=128, num_attention_heads=4,
                             feature_projection_input_dim=160, left_max_position_embeddings=8,
                             right_max_position_embeddings=2, conv_depthwise_kernel_size=5, hidden_dropout=0.0,
                             attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
                             final_dropout=0.0, layerdrop=0.0, conformer_conv_dropout=0.0,
                             apply_spec_augment=False)
    return Wav2Vec2BertModel(cfg).eval()


def test_mel_filters_and_fbank_match_jax():
    np.testing.assert_allclose(w2vbert.kaldi_mel_filters(), j_w2vbert.kaldi_mel_filters(), rtol=1e-6, atol=1e-8)
    wav = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    got = w2vbert.w2vbert_fbank(torch.from_numpy(wav))
    ref = np.asarray(j_w2vbert.w2vbert_fbank(jnp.asarray(wav)))
    assert got.shape == ref.shape == (2, 49, 160) and got.dtype == torch.float32
    _close(got, ref, (2e-4, 2e-4))


def test_w2vbert_import_matches_jax_and_hf():
    hf = _hf_w2vbert()
    cfg, jcfg = w2vbert.W2vBertConfig.from_hf(hf.config), j_w2vbert.W2vBertConfig.from_hf(hf.config)
    mine, theirs = w2vbert.w2vbert_params_from_torch(hf.state_dict(), cfg), j_w2vbert.w2vbert_params_from_torch(
        hf.state_dict(), jcfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, mine, theirs)
    port = w2vbert.W2vBertModel(cfg)
    port.load_state_dict(w2vbert.w2vbert_state_from_torch(hf.state_dict(), cfg))
    feats = np.random.default_rng(1).standard_normal((2, 37, 160)).astype(np.float32)
    ref = jax.jit(j_w2vbert.W2vBertModel(jcfg).apply)({"params": jax.tree_util.tree_map(jnp.asarray, theirs)},
                                                      jnp.asarray(feats))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(feats))
        oracle = hf(input_features=torch.from_numpy(feats)).last_hidden_state
    _close(got, ref, W2VBERT_TOL)
    _close(got, oracle, W2VBERT_TOL)


def test_w2vbert_seeded_tree_converts():
    jcfg = j_w2vbert.W2vBertConfig(hidden_size=64, num_hidden_layers=2, intermediate_size=128, num_attention_heads=4,
                                   left_max_position_embeddings=8, right_max_position_embeddings=2,
                                   conv_depthwise_kernel_size=5)
    feats = np.random.default_rng(2).standard_normal((1, 20, 160)).astype(np.float32)
    jm = j_w2vbert.W2vBertModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(feats))["params"]
    port = w2vbert.W2vBertModel(w2vbert.W2vBertConfig(**{k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__}))
    port.load_state_dict(convert.w2vbert_from_jax(_np_tree(params)))
    with torch.no_grad():
        _close(port.eval()(torch.from_numpy(feats)), jax.jit(jm.apply)({"params": params}, jnp.asarray(feats)),
               W2VBERT_TOL)


@pytest.mark.parametrize("name,tol", [("xlsr_53_56k", XLSR_TOL), ("w2v-bert", (5e-4, 5e-4))])
def test_units_encoder_encode_matches_jax(name, tol):
    hf = _hf_wav2vec2(seed=2) if name == "xlsr_53_56k" else _hf_w2vbert(seed=3)
    jue = JUnitsEncoder(name, hf_model=hf, dtype=jnp.float32)
    ue = UnitsEncoder(name, hf_model=hf, dtype=torch.float32, device="cpu")
    assert type(ue.model) is {"xlsr_53_56k": XLSRUnits, "w2v-bert": Wav2Vec2BertUnits}[name]
    wav = (np.random.default_rng(4).standard_normal(14000) * 0.1).astype(np.float32)  # 0.7 s at 20 kHz
    got = ue.encode(wav, 20000)
    assert got.shape == (1, int(14000 * 16000 / 20000) // 320, 64)
    _close(got, jue.encode(jnp.asarray(wav), 20000), tol)
