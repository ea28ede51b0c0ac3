"""The port's SVC path and the preprocessing stages it shares, against the
JAX package, on the CPU at tiny sizes.

* `TTSPipeline.infer_from_long_audio`, two ways: with a deterministic
  stand-in for `infer` in both packages (segmentation, units, mask gating
  and the silence / cross-fade stitch: the waveforms at atol 1e-6, the
  units each segment gets at the Whisper bound atol 2e-4), and with the
  real DDIM diffusion and vocoder from the same starting noise (JAX's
  per-segment draws handed to the port as `x_init`), at atol/rtol 2e-3 (the
  waveform tolerance of tests/test_torch_pipeline.py) of the waveform
  scaled to a peak of 1;
* `GaussianDiffusion.sample(k_step=, gt_spec=)` (shallow diffusion) with the
  same q_sample noise, DDIM and UniPC, at atol/rtol 2e-3;
* `kmeans_predict` and stage 19's `tokenize_units`: ids equal to JAX's, but
  for rows whose two nearest centroids tie within 1e-6 relative in f64;
* stage 10's `process_units`: JAX's units at atol 2e-4;
* the CLIs on the CPU: `cli/infer_svc.py --device cpu` writes a WAV, and
  the two stage CLIs write their files.
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.infer import TTSPipeline as JTTSPipeline
from latent_diffusion_speech_tpu.models.diffusion import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.diffusion import Unit2MelSystem as JUnit2MelSystem
from latent_diffusion_speech_tpu.models.units import UnitsEncoder as JUnitsEncoder
from latent_diffusion_speech_tpu.models.vaegan import VAEGANConfig as JVAEGANConfig
from latent_diffusion_speech_tpu.models.vaegan.codec import HifiVAEGAN
from latent_diffusion_speech_tpu.models.vocoder import Vocoder as JVocoder
from latent_diffusion_speech_tpu.models.whisper import WhisperDims as JWhisperDims
from latent_diffusion_speech_tpu_torch import config, convert
from latent_diffusion_speech_tpu_torch.cli import infer_svc, preprocess_token, preprocess_unit
from latent_diffusion_speech_tpu_torch.infer import tts as port_tts
from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline, _bucket
from latent_diffusion_speech_tpu_torch.models import units as port_units
from latent_diffusion_speech_tpu_torch.models.diffusion import samplers as P
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.models.units import UnitsEncoder
from latent_diffusion_speech_tpu_torch.models.vaegan import config as vaegan_config
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
from latent_diffusion_speech_tpu_torch.models.whisper import WhisperDims
from latent_diffusion_speech_tpu_torch.ops import audio_io
from latent_diffusion_speech_tpu_torch.quantize.kmeans import kmeans_predict

J_kmeans = importlib.import_module("latent_diffusion_speech_tpu.quantize.kmeans")
J_unit_cli = importlib.import_module("latent_diffusion_speech_tpu.cli.preprocess_unit")
J_token_cli = importlib.import_module("latent_diffusion_speech_tpu.cli.preprocess_token")

WHISPER = dict(n_mels=16, n_audio_ctx=100, n_audio_state=32, n_audio_head=4, n_audio_layer=2)
# an 8 kHz vocoder with hop 64, so a 6 s segment is ~750 latent frames
VAEGAN = dict(sampling_rate=8000, inter_channels=6, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
              upsample_rates=(8, 8), upsample_initial_channel=16, upsample_kernel_sizes=(16, 16))
U2M = dict(input_channel=32, n_spk=4, out_dims=6, n_hidden=8, block_out_channels=(8, 8), n_heads=2,
           timesteps=50, k_step=50)
UNITS = dict(atol=2e-4, rtol=0)
WAVE = dict(atol=2e-3, rtol=2e-3)
SR = 16000  # the input rate (the vocoder's is 8000: the mask path resamples)
CONFIG = Path(__file__).resolve().parent.parent / "configs" / "config.yaml"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread (see tests/test_torch_samplers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tones(parts, sr=SR, seed=0):
    """Harmonic tones with amplitude modulation, ("tone", s), and true
    silence, ("silence", s), one after another."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (kind, sec) in enumerate(parts):
        n = int(sec * sr)
        if kind == "silence":
            out.append(np.zeros(n))
            continue
        t = np.arange(n) / sr
        f0 = 140.0 + 30 * i
        y = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in (1, 2, 3))
        out.append(0.2 * y * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) + 0.003 * rng.standard_normal(n))
    return np.concatenate(out).astype(np.float32)


AUDIO = [("silence", 0.5), ("tone", 5.6), ("silence", 1.2), ("tone", 6.1), ("silence", 1.5), ("tone", 5.3)]


@pytest.fixture(scope="module")
def pipes():
    jdiff = JUnit2MelSystem(JUnit2MelConfig(**U2M))
    jvoc = JVocoder("hifi-vaegan")
    jvoc.vocoder = HifiVAEGAN.random_init(JVAEGANConfig(**VAEGAN))
    jue = JUnitsEncoder("whisper_large_v3", dims=JWhisperDims(**WHISPER), dtype=jnp.float32)
    jpipe = JTTSPipeline(jdiff, jvoc, units_encoder=jue)

    ue = UnitsEncoder("whisper_large_v3", dims=WhisperDims(**WHISPER), dtype=torch.float32, device="cpu")
    ue.model.model.load_state_dict(convert.whisper_encoder_from_jax(_np(jue.model.params)))
    pipe = TTSPipeline(
        Unit2MelSystem(Unit2MelConfig(**U2M), state_dict=convert.unit2mel_from_jax(_np(jdiff.params)), device="cpu"),
        Vocoder("hifi-vaegan", VAEGANConfig(**VAEGAN),
                state_dict=convert.generator_from_jax(_np(jvoc.vocoder.generator_params)), device="cpu"),
        units_encoder=ue,
    )
    return jpipe, pipe


class _StandIn:
    """A deterministic `infer`: T unit frames -> T * hop + extra[i] samples
    of a segment-dependent tone; it records the units it was given."""

    def __init__(self, hop, extra, wrap):
        self.hop, self.extra, self.wrap, self.units = hop, extra, wrap, []

    def __call__(self, units, **kw):
        i = len(self.units)
        self.units.append(np.asarray(units, np.float32))
        n = np.asarray(units).shape[1] * self.hop + self.extra[i]
        wav = 0.5 * np.sin(np.arange(n) * 0.01 * (i + 1)) + 0.1
        return self.wrap(wav.astype(np.float32)[None])


def test_long_audio_stitch_matches_jax_with_a_stand_in(pipes, monkeypatch):
    """Three voiced stretches (a lead-in of silence): the segments, the units
    each gets, the mask gating and the stitch.  The first stand-in output
    overruns its segment by 300 samples, so the second is cross-faded in;
    the third follows a gap (the silence branch)."""
    jpipe, pipe = pipes
    audio = _tones(AUDIO)
    j_in = _StandIn(64, [300, 0, 0], jnp.asarray)
    p_in = _StandIn(64, [300, 0, 0], torch.from_numpy)
    monkeypatch.setattr(jpipe, "infer", j_in)
    monkeypatch.setattr(pipe, "infer", p_in)
    fades = []
    real_fade = port_tts.cross_fade
    monkeypatch.setattr(port_tts, "cross_fade", lambda a, b, i: fades.append(i) or real_fade(a, b, i))

    ref, ref_sr = jpipe.infer_from_long_audio(audio, SR)
    got, sr = pipe.infer_from_long_audio(audio, SR)
    assert sr == ref_sr == 8000 and got.dtype == np.float32
    assert len(p_in.units) == len(j_in.units) == 3 and len(fades) == 1
    for g, r in zip(p_in.units, j_in.units):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, **UNITS)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # the lead-in and the middle of each silence gated to exact zeros
    for start, end in ((0, 0.5), (6.1, 7.3), (13.4, 14.9)):
        a, b = int((start + 0.2) * sr), int((end - 0.2) * sr)
        if b > a:
            assert not got[a:b].any(), (start, end)


def test_long_audio_diffusion_matches_jax_from_the_same_noise(pipes, monkeypatch):
    """The real path, DDIM (5 steps), two segments: JAX's per-segment x_T
    (the key its `infer` splits off for each segment) is the port's x_init."""
    jpipe, pipe = pipes
    audio = _tones([("tone", 5.4), ("silence", 1.0), ("tone", 5.2)], seed=1)
    seed = 3
    rng = jax.random.PRNGKey(seed)
    real_infer = pipe.infer
    draws = []

    def infer(units, **kw):
        nonlocal rng
        rng, sub = jax.random.split(rng)
        _, x_key = jax.random.split(sub)  # GaussianDiffusion.sample's x_T draw
        x0 = np.array(jax.random.normal(x_key, (1, _bucket(units.shape[1]), U2M["out_dims"]), jnp.float32))
        draws.append(x0.shape)
        return real_infer(units, x_init=torch.from_numpy(x0), **kw)

    monkeypatch.setattr(pipe, "infer", infer)
    ref, _ = jpipe.infer_from_long_audio(audio, SR, method="ddim", infer_speedup=10, seed=seed)
    got, sr = pipe.infer_from_long_audio(audio, SR, method="ddim", infer_speedup=10, seed=seed)
    assert len(draws) == 2 and sr == 8000
    peak = np.abs(ref).max()
    assert got.shape == ref.shape and np.isfinite(got).all() and peak > 0
    # the seeded vocoder's waveform peaks near 3e-5: the tolerance is taken
    # relative to that peak, so it is not met by two silences
    np.testing.assert_allclose(got / peak, ref / peak, **WAVE)


def test_long_audio_needs_a_units_encoder(pipes):
    _, pipe = pipes
    bare = TTSPipeline(pipe.diffusion, pipe.vocoder)
    with pytest.raises(ValueError, match="units encoder"):
        bare.infer_from_long_audio(np.zeros(16000, np.float32), SR)


@pytest.mark.parametrize("method,speedup", [("ddim", 5), ("unipc", 5)])
def test_shallow_diffusion_matches_jax(pipes, monkeypatch, method, speedup):
    """k_step=20 of 50 from q_sample(norm(gt), 19) with the same noise."""
    jpipe, pipe = pipes
    jsys, sys_ = jpipe.diffusion, pipe.diffusion
    rng = np.random.default_rng(4)
    units = rng.standard_normal((2, 13, 32)).astype(np.float32)
    gt = rng.standard_normal((2, 13, 6)).astype(np.float32)
    spk = np.array([[1], [3]], np.int32)
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1], gt.shape, jnp.float32))
    drawn = []
    monkeypatch.setattr(P, "_normal", lambda x, g: drawn.append(x.shape) or torch.from_numpy(noise.copy()))
    infer = jax.jit(lambda p, u, s, g: jsys.infer(u, key, spk_id=s, params=p, method=method, infer_speedup=speedup,
                                                  gt_spec=g, k_step=20))
    ref = np.asarray(infer(jsys.params, jnp.asarray(units), jnp.asarray(spk), jnp.asarray(gt)))
    got = sys_.infer(torch.from_numpy(units), spk_id=torch.from_numpy(spk).long(), method=method,
                     infer_speedup=speedup, gt_spec=torch.from_numpy(gt), k_step=20)
    assert drawn == [gt.shape] and got.shape == ref.shape == gt.shape
    np.testing.assert_allclose(got.numpy(), ref, **WAVE)
    # without gt_spec the same call starts from pure noise over all k_step steps
    full = sys_.infer(torch.from_numpy(units), torch.Generator().manual_seed(0), spk_id=torch.from_numpy(spk).long(),
                      method=method, infer_speedup=speedup, k_step=20)
    assert not np.allclose(full.numpy(), ref, atol=1e-2)


def _tie_safe_equal(got, ref, x, c):
    """ids equal, but where the f64 distances of the two choices tie within
    1e-6 relative (f32 sums in another order can flip only such a tie)."""
    x, c = np.asarray(x, np.float64).reshape(-1, c.shape[1]), np.asarray(c, np.float64)
    g, r = np.asarray(got).reshape(-1), np.asarray(ref).reshape(-1)
    for i in np.nonzero(g != r)[0]:
        dg, dr = ((x[i] - c[g[i]]) ** 2).sum(), ((x[i] - c[r[i]]) ** 2).sum()
        assert abs(dg - dr) <= 1e-6 * max(dg, dr), (i, dg, dr)


@pytest.mark.parametrize("shape", [(37, 32), (2, 37, 32), (1, 32)])
def test_kmeans_predict_matches_jax(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    c = rng.standard_normal((50, 32)).astype(np.float32)
    got = kmeans_predict(x, c)
    ref = np.asarray(J_kmeans.kmeans_predict(x, c))
    assert got.shape == ref.shape == shape[:-1] and got.dtype == torch.int32
    _tie_safe_equal(got.numpy(), ref, x, c)


def _layout(root, seed=0):
    """A corpus layout: 3 speakers, files of 0.3-2.1 s at mixed rates."""
    rng = np.random.default_rng(seed)
    for i, (sec, sr) in enumerate([(0.3, 16000), (1.1, 22050), (2.1, 44100), (0.02, 16000), (1.7, 8000)]):
        path = root / "audio" / f"spk{i % 3}" / f"f{i}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        audio_io.write_wav(path, (0.2 * rng.standard_normal(int(sec * sr))).astype(np.float32), sr)


def test_stages_10_and_19_match_jax(pipes, tmp_path):
    """Stage 10 then stage 19 over the same layout in both packages: the
    same files, units at atol 2e-4 and the same token ids."""
    jpipe, pipe = pipes
    roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for root in roots.values():
        _layout(root)
    ref = dict(J_unit_cli.process_units(roots["jax"], jpipe.units_encoder, 44100))
    got = dict(preprocess_unit.process_units(roots["port"], pipe.units_encoder, 44100))
    assert got == ref and len(got) == 5
    for name in got:
        u, r = (np.load(roots[k] / "units" / (name + ".npy")) for k in ("port", "jax"))
        assert u.dtype == np.float32
        np.testing.assert_allclose(u, r, **UNITS)
    c = np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32)
    ref_t = dict(J_token_cli.tokenize_units(roots["jax"], c))
    got_t = dict(preprocess_token.tokenize_units(roots["port"], c, device="cpu"))
    assert got_t == ref_t and len(got_t) == 5
    for name in got_t:
        ids, r = (np.load(roots[k] / "semantic_token" / name) for k in ("port", "jax"))
        assert ids.dtype == np.int32 and ids.shape == r.shape
        _tie_safe_equal(ids, r, np.load(roots["port"] / "units" / name), c)


@pytest.fixture
def tiny_cli(monkeypatch, tmp_path):
    """The shipped config at tiny widths (tests/test_torch_serve_entry.py's
    shrink), a tiny vocoder, and a one-layer Whisper 1280 wide (the width
    the config's encoder gives the units)."""
    monkeypatch.setattr(vaegan_config, "VAEGANConfig", lambda: VAEGANConfig(**VAEGAN))
    monkeypatch.setattr(port_units, "WhisperDims",
                        lambda: WhisperDims(n_mels=16, n_audio_state=1280, n_audio_head=4, n_audio_layer=1))
    cfg = config.load_config(CONFIG)
    cfg.common.n_spk = 4
    cfg.common.vocoder.ckpt = str(tmp_path / "no-vocoder")
    m = cfg.diffusion.model
    m.block_out_channels, m.n_heads, m.n_hidden, m.n_layers, m.out_dims = (8, 8), 2, 8, 1, 6
    lm = cfg.text2semantic.model
    lm.codebook_path = str(tmp_path / "codebook.npz")
    lm.semantic_kmeans_num = 32
    for stack in (lm.encoder, lm.decoder):
        stack.hidden_size, stack.num_attention_heads, stack.num_hidden_layers, stack.intermediate_size = 16, 2, 1, 16
    cfg.data.train_path, cfg.data.valid_path = str(tmp_path / "train"), str(tmp_path / "val")
    path = tmp_path / "tiny.yaml"
    config.save_config(cfg, path)
    return cfg, path


def test_cli_infer_svc_writes_a_wav(tiny_cli, tmp_path):
    _, path = tiny_cli
    src, out = tmp_path / "in.wav", tmp_path / "out.wav"
    audio_io.write_wav(src, _tones([("silence", 0.3), ("tone", 1.0)]), SR)
    infer_svc.main(["-c", str(path), "-i", str(src), "-o", str(out), "--speedup", "250", "--device", "cpu",
                    "--units-ckpt", str(tmp_path / "no-encoder.pt")])
    wav, sr = audio_io.read_wav(out)
    assert sr == 8000 and wav.ndim == 1 and np.isfinite(wav).all()
    assert abs(len(wav) - 1.3 * sr) <= 64  # the input's length at the output rate, within a hop


def test_cli_stages_10_and_19_write_their_files(tiny_cli, tmp_path):
    cfg, path = tiny_cli
    _layout(tmp_path / "train")
    preprocess_unit.main(["-c", str(path), "--device", "cpu", "--ckpt", str(tmp_path / "no-encoder.pt")])
    units = sorted((tmp_path / "train" / "units").rglob("*.npy"))
    assert len(units) == 5 and all(np.load(u).shape[1] == 1280 for u in units)
    from latent_diffusion_speech_tpu_torch.quantize.kmeans import load_codebook

    c = np.random.default_rng(2).standard_normal((32, 1280)).astype(np.float32)
    np.savez(cfg.text2semantic.model.codebook_path, cluster_centers_=c)
    np.testing.assert_array_equal(load_codebook(cfg.text2semantic.model.codebook_path), c)
    preprocess_token.main(["-c", str(path), "--device", "cpu"])
    for u in units:
        ids = np.load(tmp_path / "train" / "semantic_token" / u.relative_to(tmp_path / "train" / "units"))
        np.testing.assert_array_equal(ids, kmeans_predict(np.load(u), c).numpy())
