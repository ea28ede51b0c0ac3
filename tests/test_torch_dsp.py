"""The port's DSP ops against the JAX package's, on the CPU.

`ops/{mel,stft,resample,volume,slicer,alignment,audio_io}.py`: the same
numpy-seeded inputs through each JAX function and its port.  Tolerances:
the mel filterbank atol 2e-7 and the STFT atol 2e-3 (the JAX package's own
bounds, tests/test_ops_dsp.py); the Hann window atol 1e-6 (the same file's
bound against torch.hann_window); the Whisper log-mel atol 1e-4 (values
O(1): log10 of the STFT power, both in f32); the resampler atol 1e-5 (an f32
convolution of O(1) samples with 475-tap filters, summed in another
order); the volume, mask and upsampling atol 1e-6 (f32 means and linear
weights); the numpy copies (filterbank scales, slicer, cross-fade, frame
indices, WAV reading) exactly equal.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from latent_diffusion_speech_tpu_torch.ops import alignment, audio_io, mel, resample, slicer, stft, volume

# the JAX modules themselves (`ops/__init__.py` re-exports functions named
# after some of them, which `from ... import` would pick)
J_align, J_io, J_mel, J_rs, J_slicer, J_stft, J_vol = (
    importlib.import_module(f"latent_diffusion_speech_tpu.ops.{m}")
    for m in ("alignment", "audio_io", "mel", "resample", "slicer", "stft", "volume"))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax,htk,norm", [
    (16000, 400, 128, 0.0, None, False, "slaney"),
    (16000, 400, 80, 0.0, None, False, "slaney"),
    (44100, 2048, 128, 40.0, 16000.0, False, "slaney"),
    (22050, 1024, 64, 0.0, 8000.0, True, None),
])
def test_mel_filterbank_matches_jax(sr, n_fft, n_mels, fmin, fmax, htk, norm):
    got = mel.mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax, htk=htk, norm=norm)
    ref = J_mel.mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax, htk=htk, norm=norm)
    assert got.shape == ref.shape == (n_mels, 1 + n_fft // 2)
    np.testing.assert_allclose(got, ref, atol=2e-7)
    f = np.array([0.0, 440.0, 1000.0, 8000.0, 22050.0])
    np.testing.assert_array_equal(mel.hz_to_mel(f, htk), J_mel.hz_to_mel(f, htk))
    m = J_mel.hz_to_mel(f, htk)
    np.testing.assert_array_equal(mel.mel_to_hz(m, htk), J_mel.mel_to_hz(m, htk))


def test_hann_window_and_frame_match_jax(rng):
    np.testing.assert_allclose(stft.hann_window(1024).numpy(), np.asarray(J_stft.hann_window(1024)), atol=1e-6)
    y = rng.standard_normal((2, 1000)).astype(np.float32)
    np.testing.assert_array_equal(stft.frame(_t(y), 400, 160).numpy(), np.asarray(J_stft.frame(jnp.asarray(y), 400, 160)))


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n_fft,hop,win", [(400, 160, None), (2048, 512, None), (1024, 256, None), (1024, 256, 800)])
def test_stft_matches_jax(rng, center, n_fft, hop, win):
    y = rng.standard_normal((2, 8192)).astype(np.float32)
    got = stft.stft(_t(y), n_fft, hop, win_length=win, center=center).numpy()
    ref = np.asarray(J_stft.stft(jnp.asarray(y), n_fft, hop, win_length=win, center=center))
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("n_mels,padding", [(128, 0), (80, 480)])
def test_whisper_log_mel_matches_jax(rng, n_mels, padding):
    """Two rows 40 dB apart: the max - 8 floor is taken over the whole
    tensor, so the quiet row is floored by the loud one's maximum."""
    y = rng.standard_normal((2, 16000)).astype(np.float32) * np.array([[0.5], [0.005]], np.float32)
    got = stft.whisper_log_mel(_t(y), n_mels=n_mels, padding=padding).numpy()
    ref = np.asarray(J_stft.whisper_log_mel(jnp.asarray(y), n_mels=n_mels, padding=padding))
    assert got.shape == ref.shape == (2, n_mels, (16000 + padding) // 160)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert got[1].min() == pytest.approx(got.max() - 2.0, abs=1e-5)  # (max - 8 + 4) / 4 across rows


@pytest.mark.parametrize("orig,new", [(44100, 16000), (16000, 44100), (22050, 16000), (8000, 16000), (16000, 8000)])
def test_resample_matches_jax(rng, orig, new):
    y = rng.standard_normal((2, 3001)).astype(np.float32) * 0.3
    got = resample.resample(_t(y), orig, new).numpy()
    ref = np.asarray(J_rs.resample(jnp.asarray(y), orig, new))
    assert got.shape == ref.shape == (2, int(np.ceil(3001 * new / orig)))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert resample.resample(_t(y), orig, orig) is not None
    k, w, o, n = resample.resample_kernel(orig, new)
    jk, jw, jo, jn = J_rs.resample_kernel(orig, new)
    assert (w, o, n) == (jw, jo, jn)
    np.testing.assert_array_equal(k, np.asarray(jk))


@pytest.mark.parametrize("hop", [512, 160, 7])
def test_extract_volume_matches_jax(rng, hop):
    y = rng.standard_normal((2, 5000)).astype(np.float32) * np.linspace(0, 1, 5000, dtype=np.float32)
    got = volume.extract_volume(_t(y), hop).numpy()
    ref = np.asarray(J_vol.extract_volume(jnp.asarray(y), hop))
    assert got.shape == ref.shape == (2, 5000 // hop + 1)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("block,threshold_db", [(512, -60.0), (64, -40.0), (5, -20.0)])
def test_volume_mask_matches_jax(rng, block, threshold_db):
    """A volume track with isolated loud frames and runs: the 9-tap running
    max and the edge padding decide the mask's edges."""
    v = (rng.random((2, 40)) * 0.02).astype(np.float32)
    v[:, [3, 17, 18, 19, 39]] = 0.5
    got = volume.get_volume_mask(_t(v), block, threshold_db).numpy()
    ref = np.asarray(J_vol.get_volume_mask(jnp.asarray(v), block, threshold_db))
    assert got.shape == ref.shape == (2, 40 * block)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    one = volume.get_volume_mask(_t(v[0]), block, threshold_db).numpy()
    np.testing.assert_allclose(one, ref[:1], atol=1e-6)
    s = rng.standard_normal((1, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(volume.upsample_frames(_t(s), 4).numpy(),
                               np.asarray(J_vol.upsample_frames(jnp.asarray(s), 4)), atol=1e-6)


def _voiced(rng, sr, parts):
    """Concatenated stretches: ("tone", seconds) or ("silence", seconds)."""
    out = []
    for kind, sec in parts:
        n = int(sec * sr)
        if kind == "tone":
            t = np.arange(n) / sr
            out.append(0.3 * np.sin(2 * np.pi * 220 * t) + 0.01 * rng.standard_normal(n))
        else:
            out.append(np.zeros(n))
    return np.concatenate(out).astype(np.float32)


@pytest.mark.parametrize("parts", [
    [("silence", 0.5), ("tone", 6.0), ("silence", 1.5), ("tone", 5.5), ("silence", 1.0), ("tone", 7.0)],
    [("tone", 6.0), ("silence", 0.4), ("tone", 6.0), ("silence", 12.0), ("tone", 5.2), ("silence", 2.0)],
    [("tone", 3.0)],
])
def test_slicer_matches_jax(rng, parts):
    y = _voiced(rng, 8000, parts)
    got = slicer.Slicer(8000).slice(y)
    ref = J_slicer.Slicer(8000).slice(y)
    assert [(s.voiced, s.start, s.end) for s in got] == [(s.voiced, s.start, s.end) for s in ref]
    got_v = slicer.split_voiced(y, 8000, 64)
    ref_v = J_slicer.split_voiced(y, 8000, 64)
    assert [f for f, _ in got_v] == [f for f, _ in ref_v]
    for (_, a), (_, b) in zip(got_v, ref_v):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("la,lb,idx", [(100, 80, 60), (100, 40, 100), (50, 60, 0), (20, 100, 5)])
def test_cross_fade_matches_jax(rng, la, lb, idx):
    """Partial overlap, no overlap (idx at a's end), b faded in from a's
    start, and a b longer than a."""
    a = rng.standard_normal(la).astype(np.float32)
    b = rng.standard_normal(lb).astype(np.float32)
    got, ref = alignment.cross_fade(a, b, idx), J_align.cross_fade(a, b, idx)
    assert got.dtype == ref.dtype and got.shape == (idx + lb,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sr,target", [(22050, 16000), (44100, None), (16000, 16000)])
def test_load_audio_matches_jax(tmp_path, rng, sr, target):
    """A stereo 16-bit WAV: mono by its first channel, resampled when the
    rates differ."""
    y = (rng.standard_normal((4000, 2)) * 0.2).astype(np.float32)
    path = tmp_path / "x.wav"
    audio_io.write_wav(path, y, sr)
    got, got_sr = audio_io.load_audio(path, target_sr=target)
    ref, ref_sr = J_io.load_audio(path, target_sr=target)
    assert got_sr == ref_sr == (target or sr) and got.dtype == np.float32
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
    stereo, _ = audio_io.load_audio(path, mono=False)
    assert stereo.shape == (4000, 2)


def test_load_audio_non_wav_without_ffmpeg_raises(tmp_path, monkeypatch):
    import shutil

    path = tmp_path / "x.mp3"
    path.write_bytes(b"ID3not-a-wav")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(ValueError, match="ffmpeg"):
        audio_io.load_audio(path)
