"""The port's Whisper encoder and unit extraction against the JAX package.

At the tiny dims of tests/test_whisper_units.py, f32 on the CPU, atol 2e-4
(the JAX package's own bound for its encoder against the torch reference,
tests/test_whisper_units.py:107), with the same weights loaded three ways:
a reference-layout state dict (JAX through
`whisper_encoder_params_from_torch`, the port through `load_state_dict`),
JAX's seeded tree through `convert.whisper_encoder_from_jax`, and a
`torch.save`d `{"dims", "model_state_dict"}` checkpoint through
`WhisperLargeV3Units`.  In bf16 the port's units are held to JAX's bf16
units at a relative RMS error of 2e-2: the same casts (LayerNorms in f32,
cast back; f32 `ln_post` units), with bf16 products rounded in another
order (JAX's own bf16 units are 0.6-0.8% RMS from its f32 units here).
`UnitsEncoder.encode` (resampling, the 400-sample minimum, the bucket
padding before the encoder, the crop) is compared the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.units import UnitsEncoder as JUnitsEncoder
from latent_diffusion_speech_tpu.models.units import WhisperLargeV3Units as JWhisperLargeV3Units
from latent_diffusion_speech_tpu.models.whisper import WhisperDims as JWhisperDims
from latent_diffusion_speech_tpu.models.whisper import WhisperEncoder as JWhisperEncoder
from latent_diffusion_speech_tpu.models.whisper import whisper_encoder_params_from_torch
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.models.units import (
    UnitsEncoder,
    WhisperLargeV3Units,
    get_encoder_out_channels,
    whisper_state_from_reference,
)
from latent_diffusion_speech_tpu_torch.models.whisper import WhisperDims, WhisperEncoder
from latent_diffusion_speech_tpu_torch.models.whisper.model import sinusoids

TINY = dict(n_mels=16, n_audio_ctx=100, n_audio_state=32, n_audio_head=4, n_audio_layer=2)
F32 = dict(atol=2e-4, rtol=0)
BF16_RMS = 2e-2


def _reference_state(seed=0, prefix="encoder."):
    """A reference AudioEncoder state dict at TINY dims (`encoder.*` keys,
    with the `positional_embedding` buffer real checkpoints carry)."""
    rng = np.random.default_rng(seed)
    C, M, L = TINY["n_audio_state"], TINY["n_mels"], TINY["n_audio_layer"]

    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape) / np.sqrt(shape[-1] if len(shape) == 2 else
                                                                       shape[1] * shape[2])).astype(np.float32))

    def b(n):
        return torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))

    sd = {"conv1.weight": w(C, M, 3), "conv1.bias": b(C), "conv2.weight": w(C, C, 3), "conv2.bias": b(C),
          "ln_post.weight": 1 + b(C), "ln_post.bias": b(C), "positional_embedding": sinusoids(100, C)}
    for i in range(L):
        p = f"blocks.{i}."
        for ln in ("attn_ln", "mlp_ln"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = 1 + b(C), b(C)
        for name in ("query", "key", "value", "out"):
            sd[p + f"attn.{name}.weight"] = w(C, C)
            if name != "key":
                sd[p + f"attn.{name}.bias"] = b(C)
        sd[p + "mlp.0.weight"], sd[p + "mlp.0.bias"] = w(4 * C, C), b(4 * C)
        sd[p + "mlp.2.weight"], sd[p + "mlp.2.bias"] = w(C, 4 * C), b(C)
    return {prefix + k: v for k, v in sd.items()}


def _port_encoder(state):
    enc = WhisperEncoder(WhisperDims(**TINY))
    enc.load_state_dict(state)
    return enc.eval()


def _mel(rng, B=2, T=50):
    return rng.standard_normal((B, TINY["n_mels"], T)).astype(np.float32)


@pytest.mark.parametrize("T", [50, 51, 8])
def test_reference_state_dict_loads_into_both(rng, T):
    """One reference-layout state dict: JAX through its importer, the port
    through load_state_dict (prefix stripped, positions dropped)."""
    ref_state = _reference_state()
    params = whisper_encoder_params_from_torch(ref_state, JWhisperDims(**TINY))
    mel = _mel(rng, T=T)
    ref = JWhisperEncoder(JWhisperDims(**TINY)).apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                                     jnp.asarray(mel))
    with torch.no_grad():
        got = _port_encoder(whisper_state_from_reference(ref_state))(torch.from_numpy(mel))
    assert got.shape == ref.shape == (2, (T + 1) // 2, TINY["n_audio_state"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_strict_load_names_match_the_reference():
    state = whisper_state_from_reference(_reference_state(prefix=""))
    assert set(state) == set(WhisperEncoder(WhisperDims(**TINY)).state_dict())
    assert "blocks.1.attn.key.bias" not in state


def test_jax_seeded_tree_converts(rng):
    jenc = JWhisperEncoder(JWhisperDims(**TINY))
    mel = _mel(rng)
    params = jenc.init(jax.random.PRNGKey(3), jnp.asarray(mel))["params"]
    ref = jenc.apply({"params": params}, jnp.asarray(mel))
    state = convert.whisper_encoder_from_jax(jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = _port_encoder(state)(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_bf16_units_match_jax_and_come_out_f32(rng):
    """bf16 compute: LayerNorms in f32 cast back to bf16, `ln_post` f32."""
    ref_state = _reference_state(seed=1)
    params = whisper_encoder_params_from_torch(ref_state, JWhisperDims(**TINY))
    mel = _mel(rng)
    ref = JWhisperEncoder(JWhisperDims(**TINY), dtype=jnp.bfloat16).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)}, jnp.asarray(mel))
    from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype

    enc = cast_compute_dtype(_port_encoder(whisper_state_from_reference(ref_state)), torch.bfloat16)
    assert enc.blocks[0].attn_ln.weight.dtype == torch.float32 and enc.conv1.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = enc(torch.from_numpy(mel))
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    ref = np.asarray(ref)
    assert np.sqrt(((got.numpy() - ref) ** 2).mean() / (ref**2).mean()) <= BF16_RMS


def test_checkpoint_file_through_whisper_large_v3_units(tmp_path, rng):
    """A tiny `torch.save`d reference checkpoint: both packages read dims
    and weights from it (no seeded weights) and give the same units."""
    path = tmp_path / "tiny_encoder.pt"
    torch.save({"dims": dict(TINY, n_vocab=51866), "model_state_dict": _reference_state(seed=2)}, path)
    port = WhisperLargeV3Units(str(path), dtype=torch.float32, device="cpu")
    jax_units = JWhisperLargeV3Units(str(path), dtype=jnp.float32)
    assert port.dims == WhisperDims(**TINY)
    audio = (rng.standard_normal((1, 8000)) * 0.1).astype(np.float32)
    got = port(torch.from_numpy(audio))
    ref = jax_units(jnp.asarray(audio))
    assert got.shape == ref.shape == (1, 25, TINY["n_audio_state"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_missing_checkpoint_seeds_weights(capsys):
    a = WhisperLargeV3Units("no/such/file.pt", dims=WhisperDims(**TINY), dtype=torch.float32, device="cpu")
    assert "[!] no Whisper checkpoint at no/such/file.pt" in capsys.readouterr().out
    b = WhisperLargeV3Units(None, dims=WhisperDims(**TINY), dtype=torch.float32, device="cpu")
    c = WhisperLargeV3Units(None, dims=WhisperDims(**TINY), dtype=torch.float32, device="cpu", seed=1)
    for (name, pa), pb, pc in zip(a.model.named_parameters(), b.model.parameters(), c.model.parameters()):
        assert torch.equal(pa, pb), name
        assert torch.isfinite(pa).all()
    w = a.model.blocks[0].mlp[0].weight
    assert not torch.equal(w, c.model.blocks[0].mlp[0].weight)
    assert abs(w.std().item() * np.sqrt(32) - 1.0) < 0.2  # LeCun-normal scale
    assert torch.equal(a.model.blocks[0].attn_ln.weight, torch.ones(32))


@pytest.fixture(scope="module")
def encoders():
    """The JAX UnitsEncoder (seeded) and the port's with its weights."""
    out = {}
    for mode in ("nearest", "rfa512to441"):
        jue = JUnitsEncoder("whisper_large_v3", units_forced_mode=mode, dims=JWhisperDims(**TINY),
                            dtype=jnp.float32)
        ue = UnitsEncoder("whisper_large_v3", units_forced_mode=mode, dims=WhisperDims(**TINY),
                          dtype=torch.float32, device="cpu")
        ue.model.model.load_state_dict(
            convert.whisper_encoder_from_jax(jax.tree_util.tree_map(np.asarray, jue.model.params)))
        out[mode] = jue, ue
    return out


@pytest.mark.parametrize("mode,n,sr", [
    ("nearest", 44100, 44100), ("nearest", 12345, 44100), ("nearest", 100, 16000), ("nearest", 8000, 16000),
    ("nearest", 9000, 22050),
    # rfa512to441 forces the encoder rate to 13781 Hz: an input at twice
    # that rate keeps the polyphase bank small (2:1)
    ("rfa512to441", 20000, 27562), ("rfa512to441", 13781, 13781),
])
def test_units_encoder_encode_matches_jax(encoders, rng, mode, n, sr):
    """44.1 kHz input resampled, a short input padded to 400 samples, input
    padded to the half-second bucket before the encoder and cropped after,
    and the rate-forcing mode's detuned encoder rate."""
    jue, ue = encoders[mode]
    assert ue.encoder_sample_rate == jue.encoder_sample_rate
    audio = (rng.standard_normal(n) * 0.1).astype(np.float32)
    ref = np.asarray(jue.encode(jnp.asarray(audio), sr))
    got = ue.encode(audio, sr)
    assert got.shape == ref.shape and got.dtype == torch.float32
    T = max(400, int(np.ceil(n * ue.encoder_sample_rate / sr)))
    assert got.shape[1] == T // 320
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def test_bucket_padding_changes_what_attention_sees(encoders, rng):
    """Without the bucket padding the units differ: the port pads as JAX
    does because attention sees the padded frames."""
    _, ue = encoders["nearest"]
    audio = (rng.standard_normal(12000) * 0.1).astype(np.float32)
    padded, bare = ue.encode(audio, 16000), ue.encode(audio, 16000, pad_to_bucket=False)
    assert padded.shape == bare.shape
    assert (padded - bare).abs().max() > 1e-3


def test_registry_and_unported_encoders(monkeypatch):
    """Every encoder name builds its encoder (the other three are ported:
    their full-width builds are stubbed here, tests/test_torch_units_alt.py
    runs them)."""
    from latent_diffusion_speech_tpu_torch.models import units as port_units

    assert get_encoder_out_channels("whisper_large_v3") == 1280
    assert get_encoder_out_channels("hubert_soft") == 256
    assert get_encoder_out_channels("w2v-bert") == get_encoder_out_channels("xlsr_53_56k") == 1024
    with pytest.raises(ValueError):
        get_encoder_out_channels("nope")
    monkeypatch.setattr(port_units, "_built", lambda factory, device, state, seed, dtype: None)
    for name, cls in (("hubert_soft", port_units.HubertSoftUnits), ("w2v-bert", port_units.Wav2Vec2BertUnits),
                      ("xlsr_53_56k", port_units.XLSRUnits)):
        kw = {"cache_dir": "no-such-cache"} if name == "w2v-bert" else {}
        assert type(UnitsEncoder(name, device="cpu", **kw).model) is cls
    with pytest.raises(ValueError, match="Unknown units encoder"):
        UnitsEncoder("not_an_encoder", device="cpu")
