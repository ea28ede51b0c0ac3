"""The port's HiFi-VAEGAN codec against the JAX package's, on the CPU.

* `VAEEncoder` m and logs against the flax module on the same weights
  (numpy draws on the JAX tree, moved over with `convert.encoder_from_jax`)
  for ResBlock1, ResBlock2 (k - u odd) and a non-default geometry;
* the reference importer (`models/vaegan/import_torch.py`) against the JAX
  importer followed by `convert.py`: the same state dict, encoder and
  generator, from reference-architecture modules (tests/test_vaegan.py's
  `TorchEncoder` / `TorchGenerator`) with trained-like weight-norm
  magnitudes (g != ||v||, tests/test_verify_import.py) and from a
  reference-layout ResBlock2 state dict;
* `HifiVAEGAN.from_torch_checkpoint` on an `encoder.pth` / `decoder.pth`
  pair against JAX's on the same files: `extract` (m, logs), `decode`,
  `get_mel` at keyshift 0 and +-2; `Vocoder.extract` at 16 kHz and 44.1 kHz;
* `only_mean` zeroes logs; `only_z`'s (z - m) * exp(-logs) is a standard
  normal (mean and standard deviation within 0.05 over 12000 draws);
* `istft(stft(y))` equals y, and the port's `istft` equals JAX's;
* `build_pipeline` serves an existing checkpoint directory.

Tolerances: the encoder, extract and decode atol 5e-5, rtol 1e-4 (the JAX
package's importer tolerance, tests/test_verify_import.py); the log-mel atol
1e-4 (the Whisper log-mel's bound in tests/test_torch_dsp.py: f32 FFTs of
two libraries, then a log); istft atol 1e-5 (f32 round trip of O(1)
samples); importers exact (the same numpy folding, layouts moved without
arithmetic).
"""

import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.vaegan import VAEGANConfig as JVAEGANConfig
from latent_diffusion_speech_tpu.models.vaegan import import_torch as j_import
from latent_diffusion_speech_tpu.models.vaegan.codec import HifiVAEGAN as JHifiVAEGAN
from latent_diffusion_speech_tpu.models.vaegan.models import VAEEncoder as JVAEEncoder
from latent_diffusion_speech_tpu.models.vocoder import Vocoder as JVocoder
from latent_diffusion_speech_tpu_torch import config, convert
from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline
from latent_diffusion_speech_tpu_torch.models.vaegan import import_torch
from latent_diffusion_speech_tpu_torch.models.vaegan.codec import HifiVAEGAN
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vaegan.models import VAEEncoder
from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
from latent_diffusion_speech_tpu_torch.ops import stft as port_stft
from tests.test_vaegan import TINY, TorchEncoder, TorchGenerator

j_stft = importlib.import_module("latent_diffusion_speech_tpu.ops.stft")

ATOL, RTOL = 5e-5, 1e-4
CONFIG = Path(__file__).resolve().parent.parent / "configs" / "config.yaml"
GEOMETRIES = {
    "resblock1": dataclasses.asdict(TINY),
    "resblock2_odd_kernel": dict(sampling_rate=8000, inter_channels=4, resblock="2",
                                 resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
                                 upsample_rates=(3, 2), upsample_initial_channel=8, upsample_kernel_sizes=(7, 5)),
    "nondefault": dict(dataclasses.asdict(TINY), resblock_kernel_sizes=(3, 5, 7),
                       resblock_dilation_sizes=((1, 2, 4), (2, 6, 8), (1, 3, 9)), upsample_rates=(4, 2, 2),
                       upsample_kernel_sizes=(8, 4, 4), upsample_initial_channel=24),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread (the parallel run's workers would
    otherwise spin against each other on every small op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _numpy_weights(tree, rng):
    """The JAX tree's structure with numpy draws at a trained scale:
    kernels N(0, 1 / fan_in), biases N(0, 0.01)."""
    def draw(path, leaf):
        name = path[-1].key
        scale = (1.0 / np.prod(leaf.shape[:-1])) ** 0.5 if name == "kernel" else 0.1
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, _np(tree))


def _randomize_weight_norm(model, rng):
    """Trained weight-norm magnitudes: g != ||v|| (tests/test_verify_import.py)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight_g"):
                p.mul_(torch.from_numpy(rng.uniform(0.2, 3.0, p.shape).astype(np.float32)))
    return model


def _h(cfg: JVAEGANConfig, **over) -> dict:
    h = {k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(cfg).items()}
    h["resblock_dilation_sizes"] = [list(d) for d in cfg.resblock_dilation_sizes]
    return {**h, **over}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A reference-layout `encoder.pth` / `decoder.pth` pair of the TINY
    geometry at 44.1 kHz, with trained-like weight-norm magnitudes."""
    rng = np.random.default_rng(7)
    torch.manual_seed(7)
    path = tmp_path_factory.mktemp("hifi-vaegan")
    h = _h(TINY, sampling_rate=44100)
    enc = _randomize_weight_norm(TorchEncoder(TINY).eval(), rng)
    dec = _randomize_weight_norm(TorchGenerator(TINY).eval(), rng)
    torch.save({"model": enc.state_dict(), "config": h}, path / "encoder.pth")
    torch.save({"model": dec.state_dict(), "config": h}, path / "decoder.pth")
    return path


@pytest.fixture(scope="module")
def codecs(checkpoint):
    return JHifiVAEGAN.from_torch_checkpoint(checkpoint), HifiVAEGAN.from_torch_checkpoint(checkpoint, device="cpu")


# -- the encoder module ----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_encoder_matches_jax(rng, name):
    jcfg, cfg = JVAEGANConfig(**GEOMETRIES[name]), VAEGANConfig(**GEOMETRIES[name])
    params = _numpy_weights(JHifiVAEGAN.random_init(jcfg).encoder_params, rng)
    audio = (0.3 * rng.standard_normal((2, cfg.hop_size * 12))).astype(np.float32)
    _, m_j, logs_j = JVAEEncoder(jcfg).apply({"params": params}, jnp.asarray(audio), rng=jax.random.PRNGKey(0))
    enc = VAEEncoder(cfg).eval()
    enc.load_state_dict(convert.encoder_from_jax(params))
    with torch.no_grad():
        z, m, logs = enc(torch.from_numpy(audio), sample=False)
    assert m.shape == (2, 12, cfg.inter_channels) and torch.equal(z, m)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(logs.numpy(), np.asarray(logs_j), atol=ATOL, rtol=RTOL)


# -- the reference importer ------------------------------------------------------


def _assert_same_state(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("which", ["encoder", "generator"])
def test_reference_importer_matches_jax_importer(rng, which):
    cfg = VAEGANConfig(**dataclasses.asdict(TINY))
    if which == "encoder":
        state = _randomize_weight_norm(TorchEncoder(TINY).eval(), rng).state_dict()
        got = import_torch.encoder_state_from_torch(state, cfg)
        want = convert.encoder_from_jax(j_import.encoder_params_from_torch(state, TINY))
        module = VAEEncoder(cfg)
    else:
        state = _randomize_weight_norm(TorchGenerator(TINY).eval(), rng).state_dict()
        got = import_torch.generator_state_from_torch(state, cfg)
        want = convert.generator_from_jax(j_import.generator_params_from_torch(state, TINY))
        from latent_diffusion_speech_tpu_torch.models.vaegan.models import Generator
        module = Generator(cfg)
    _assert_same_state(got, want)
    module.load_state_dict(got)  # every leaf of the port's module, and no other


def test_reference_importer_resblock2_layout(rng):
    """A reference-layout state dict of a ResBlock2 codec (`convs.{m}`,
    weight norm, one bias left out) through both importers."""
    geo = GEOMETRIES["resblock2_odd_kernel"]
    jcfg, cfg = JVAEGANConfig(**geo), VAEGANConfig(**geo)
    port = VAEEncoder(cfg)
    names = {"down_": "ups.", "conv_pre": "conv_pre", "conv_post": "conv_post"}
    state = {}
    for key, t in port.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        if mod.startswith("res_"):
            stage, j, m = (int(s) for s in mod.replace("res_", "").replace(".conv_", "_").split("_"))
            mod = f"resblocks.{stage * len(cfg.resblock_kernel_sizes) + j}.convs.{m}"
        else:
            mod = next(v + mod[len(k):] for k, v in names.items() if mod.startswith(k))
        if leaf == "weight":
            state[mod + ".weight_v"] = torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
            state[mod + ".weight_g"] = torch.from_numpy(rng.uniform(0.2, 3.0, (t.shape[0], 1, 1)).astype(np.float32))
        elif mod != "conv_post":
            state[mod + ".bias"] = torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
    got = import_torch.encoder_state_from_torch(state, cfg)
    _assert_same_state(got, convert.encoder_from_jax(j_import.encoder_params_from_torch(state, jcfg)))
    assert not got["conv_post.bias"].any()


# -- the codec facade on reference checkpoint files -----------------------------------


def test_from_torch_checkpoint_reads_the_geometry(codecs):
    jcodec, codec = codecs
    assert codec.cfg == VAEGANConfig(**dataclasses.asdict(jcodec.cfg))
    assert (codec.sample_rate, codec.hop_size, codec.dimension) == (44100, 8, 6)


def test_extract_matches_jax(codecs, rng):
    jcodec, codec = codecs
    audio = (0.3 * rng.standard_normal((2, 8 * 40 + 5))).astype(np.float32)  # padded to 328 on the right
    want = np.asarray(jcodec.extract(jnp.asarray(audio)))
    got = codec.extract(torch.from_numpy(audio))
    assert got.shape == want.shape == (2, 41, 12)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    mean_only = codec.extract(torch.from_numpy(audio), only_mean=True)
    np.testing.assert_array_equal(mean_only[..., :6].numpy(), got[..., :6].numpy())
    assert not mean_only[..., 6:].any()


def test_decode_matches_jax(codecs, rng):
    jcodec, codec = codecs
    z = rng.standard_normal((2, 10, 6)).astype(np.float32)
    want = np.asarray(jcodec.decode(jnp.asarray(z)))
    got = codec.decode(torch.from_numpy(z))
    assert got.shape == want.shape == (2, 80)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("keyshift", [0.0, 2.0, -2.0])
@pytest.mark.parametrize("n", [4000, 700])  # reflect padding, and the constant padding of a short input
def test_get_mel_matches_jax(codecs, rng, keyshift, n):
    jcodec, codec = codecs
    audio = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    want = np.asarray(jcodec.get_mel(jnp.asarray(audio), keyshift=keyshift))
    got = codec.get_mel(torch.from_numpy(audio), keyshift=keyshift)
    assert got.shape == want.shape and got.shape[-1] == 128
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert codec.mel.frames_for_length(n) == jcodec.mel.frames_for_length(n) == got.shape[1]


def test_only_z_draws_a_standard_normal(codecs, rng):
    _, codec = codecs
    audio = torch.from_numpy((0.3 * rng.standard_normal((2, 8 * 1000))).astype(np.float32))
    stats = codec.extract(audio)
    m, logs = stats[..., :6], stats[..., 6:]
    z = codec.extract(audio, only_z=True, generator=torch.Generator().manual_seed(3))
    eps = ((z - m) * torch.exp(-logs)).flatten()
    assert eps.numel() >= 10_000
    assert abs(eps.mean().item()) < 0.05 and abs(eps.std().item() - 1.0) < 0.05
    again = codec.extract(audio, only_z=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(z, again)
    assert torch.equal(codec.extract(audio, only_z=True), codec.extract(audio, only_z=True))


@pytest.mark.parametrize("sr", [16000, 44100])
def test_vocoder_extract_matches_jax(checkpoint, rng, sr):
    jvoc = JVocoder("hifi-vaegan", str(checkpoint))
    voc = Vocoder("hifi-vaegan", device="cpu", ckpt=str(checkpoint))
    assert voc.vocoder_sample_rate == 44100 and voc.dimension == jvoc.dimension == 12
    audio = (0.3 * rng.standard_normal((1, sr // 10))).astype(np.float32)
    want = np.asarray(jvoc.extract(jnp.asarray(audio), sr))
    got = voc.extract(torch.from_numpy(audio), sr)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_seeded_vocoder_without_a_checkpoint_directory(tmp_path):
    voc = Vocoder("hifi-vaegan", VAEGANConfig(**dataclasses.asdict(TINY)), device="cpu",
                  ckpt=str(tmp_path / "missing"))
    assert voc.cfg.sampling_rate == 8000
    ref = Vocoder("hifi-vaegan", VAEGANConfig(**dataclasses.asdict(TINY)), device="cpu")
    for a, b in zip(voc.generator.parameters(), ref.generator.parameters()):
        assert torch.equal(a, b)


# -- istft -----------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop,win", [(512, 128, None), (400, 160, 320)])
def test_istft_inverts_stft_and_matches_jax(rng, n_fft, hop, win):
    y = rng.standard_normal((2, 4480)).astype(np.float32)  # a multiple of both hops
    spec = port_stft.stft(torch.from_numpy(y), n_fft, hop, win_length=win)
    back = port_stft.istft(spec, n_fft, hop, win_length=win, length=4480)
    np.testing.assert_allclose(back.numpy(), y, atol=1e-5)
    want = np.asarray(j_stft.istft(jnp.asarray(spec.numpy()), n_fft, hop, win_length=win, length=4480))
    np.testing.assert_allclose(back.numpy(), want, atol=1e-5)
    # without centring the ends divide by a window sum near 0, which turns
    # rounding into large errors in both packages: held where that sum is > 0.1
    uncentred = port_stft.istft(spec[0], n_fft, hop, win_length=win, center=False).numpy()
    want = np.asarray(j_stft.istft(jnp.asarray(spec[0].numpy()), n_fft, hop, win_length=win, center=False))
    window = port_stft._padded_window(None, win or n_fft, n_fft, None).numpy()
    wsq = np.zeros_like(want)
    for i in range(spec.shape[-1]):
        wsq[i * hop: i * hop + n_fft] += window ** 2
    assert uncentred.shape == want.shape
    np.testing.assert_allclose(uncentred[wsq > 0.1], want[wsq > 0.1], atol=1e-5)


# -- build_pipeline ----------------------------------------------------------------


def test_build_pipeline_serves_a_vocoder_checkpoint_directory(tmp_path, checkpoint, codecs, capsys):
    cfg = config.load_config(CONFIG)
    cfg.common.n_spk = 4
    m = cfg.diffusion.model
    m.block_out_channels, m.n_heads, m.n_hidden, m.n_layers, m.out_dims = (8, 8), 2, 8, 1, 6
    lm = cfg.text2semantic.model
    lm.codebook_path = str(tmp_path / "no-codebook.npz")
    lm.semantic_kmeans_num = 32
    for stack in (lm.encoder, lm.decoder):
        stack.hidden_size, stack.num_attention_heads, stack.num_hidden_layers, stack.intermediate_size = 16, 2, 1, 16
    cfg.common.vocoder.ckpt = str(checkpoint)
    pipe = build_pipeline(cfg, dtype=torch.float32, device="cpu")
    assert "no vocoder checkpoint" not in capsys.readouterr().out
    _, codec = codecs
    assert pipe.vocoder.cfg == codec.cfg
    for (name, a), b in zip(pipe.vocoder.generator.state_dict().items(), codec.generator.state_dict().values()):
        assert torch.equal(a, b), name
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 5, 6)).astype(np.float32))
    assert torch.equal(pipe.vocoder.infer(z), codec.decode(z))
