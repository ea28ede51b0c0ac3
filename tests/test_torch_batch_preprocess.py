"""The port's batched preprocessing (`cli/batch_preprocess.py`) against the
JAX package's, on the CPU.

* JAX's fake-encoder case (tests/test_cli.py): progress and frame counts;
* tiny real encoders (the Whisper dims of tests/test_cli.py from a
  reference `{dims, model_state_dict}` checkpoint, a reference HiFi-VAEGAN
  pair at 16 kHz read at the 8 kHz encoder rate, so the codec's input is
  resampled as in JAX) over 8 files in two length buckets at batch size 2:
  every `units/` and `mel/` file equals JAX's `batch_extract` on the same
  tree within atol 1e-5, rtol 1e-4 (f32; the codec's tolerance in
  tests/test_torch_codec.py, tighter than the encoder's 2e-4 there), with
  the same frame counts and progress;
* `process_index` / `process_count` (0, 2) and (1, 2) write each file once;
* a file's units in a batch of one are stage 10's; in a batch of four the
  log-mel floor is the batch's (as in JAX), so the file holding the
  batch's log-mel maximum keeps its units (atol 1e-6: products of another
  batch size round in another order).
"""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.cli.batch_preprocess import batch_extract as j_batch_extract
from latent_diffusion_speech_tpu.models.units import UnitsEncoder as JUnitsEncoder
from latent_diffusion_speech_tpu.models.vocoder import Vocoder as JVocoder
from latent_diffusion_speech_tpu_torch.cli.batch_preprocess import batch_extract
from latent_diffusion_speech_tpu_torch.models.units import UnitsEncoder
from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
from latent_diffusion_speech_tpu_torch.ops.audio_io import write_wav
from tests.test_vaegan import TINY as VA_TINY
from tests.test_vaegan import TorchEncoder, TorchGenerator
from tests.test_whisper_units import TorchWhisperEncoder

SR = 8000  # the files' and the units encoder's rate
CODEC_SR = 16000
WHISPER = dict(n_mels=16, n_audio_ctx=100, n_audio_state=16, n_audio_head=2, n_audio_layer=1)
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio_tree(root):
    """tests/test_cli.py's tree: two speakers of three 0.2 s files and one
    of 2 s (the 0.5 s and 2 s buckets at 8 kHz)."""
    rng = np.random.default_rng(0)
    for spk in ("alice", "bob"):
        d = root / "audio" / spk
        d.mkdir(parents=True)
        for n in range(4):
            dur = 0.2 if n < 3 else 2.0
            write_wav(d / f"{n}.wav", (rng.standard_normal(int(SR * dur)) * 0.1).astype(np.float32), SR)
    return root


def _npys(root, sub):
    return sorted(str(p.relative_to(root / sub)) for p in (root / sub).rglob("*.npy"))


class FakeUnits:
    encoder_hop_size = 320

    def encode(self, audio, sr):
        return torch.zeros(audio.shape[0], audio.shape[1] // 320, 4)


class FakeVocoder:
    vocoder_hop_size = 512

    def extract(self, audio, sr):
        return torch.zeros(audio.shape[0], audio.shape[1] // 512, 8)


def test_batched_extraction_with_fake_encoders(tmp_path):
    tree = _audio_tree(tmp_path / "train")
    progress = list(batch_extract(tree, FakeUnits(), FakeVocoder(), sample_rate=SR, encoder_sr=SR, batch_size=4))
    assert progress[-1][0] == progress[-1][1] == 8
    assert np.load(tree / "units" / "alice" / "0.wav.npy").shape[0] == 1600 // 320
    assert np.load(tree / "mel" / "alice" / "0.wav.npy").shape[0] == 1600 // 512


def test_shards_cover_each_file_once(tmp_path):
    tree = _audio_tree(tmp_path / "train")
    written = []
    for index in (0, 1):
        out = tmp_path / f"shard{index}"
        shutil.copytree(tree / "audio", out / "audio")
        progress = list(batch_extract(out, FakeUnits(), FakeVocoder(), sample_rate=SR, encoder_sr=SR,
                                      batch_size=3, process_index=index, process_count=2))
        assert progress[-1] == (4, 4)
        assert _npys(out, "units") == _npys(out, "mel")
        written += _npys(out, "units")
    assert sorted(written) == sorted(f"{spk}/{n}.wav.npy" for spk in ("alice", "bob") for n in range(4))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A reference Whisper `{dims, model_state_dict}` checkpoint and a
    reference HiFi-VAEGAN pair at 16 kHz with trained-like weight norm."""
    root = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(12)
    torch.manual_seed(12)
    dims = type("Dims", (), WHISPER)
    torch.save({"dims": WHISPER, "model_state_dict": TorchWhisperEncoder(dims).state_dict_reference_layout()},
               root / "encoder.pt")
    h = {k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(VA_TINY).items()}
    h["resblock_dilation_sizes"] = [list(d) for d in VA_TINY.resblock_dilation_sizes]
    h["sampling_rate"] = CODEC_SR
    (root / "vaegan").mkdir()
    for name, module in (("encoder", TorchEncoder(VA_TINY)), ("decoder", TorchGenerator(VA_TINY))):
        with torch.no_grad():
            for n, p in module.named_parameters():
                if n.endswith("weight_g"):
                    p.mul_(torch.from_numpy(rng.uniform(0.2, 3.0, p.shape).astype(np.float32)))
        torch.save({"model": module.state_dict(), "config": h}, root / "vaegan" / f"{name}.pth")
    return root


def _port_encoders(ckpt):
    return (UnitsEncoder("whisper_large_v3", SR, 320, ckpt_path=str(ckpt / "encoder.pt"), dtype=torch.float32,
                         device="cpu"),
            Vocoder(device="cpu", ckpt=str(ckpt / "vaegan")))


def test_batch_extract_matches_jax(tmp_path, checkpoints):
    jax_tree, tree = _audio_tree(tmp_path / "jax"), _audio_tree(tmp_path / "port")
    j_units = JUnitsEncoder("whisper_large_v3", SR, 320, ckpt_path=str(checkpoints / "encoder.pt"),
                            dtype=jnp.float32)
    j_vocoder = JVocoder("hifi-vaegan", str(checkpoints / "vaegan"))
    kw = dict(sample_rate=CODEC_SR, encoder_sr=SR, batch_size=2)
    want = list(j_batch_extract(jax_tree, j_units, j_vocoder, **kw))
    got = list(batch_extract(tree, *_port_encoders(checkpoints), **kw))
    assert got == want == [(2, 8), (4, 8), (6, 8), (8, 8)]
    for sub, frames in (("units", lambda n: n // 320), ("mel", lambda n: n * CODEC_SR // SR // VA_TINY.hop_size)):
        names = _npys(tree, sub)
        assert names == _npys(jax_tree, sub) and len(names) == 8
        for name in names:
            a, b = np.load(tree / sub / name), np.load(jax_tree / sub / name)
            n = int(SR * (2.0 if name.endswith("3.wav.npy") else 0.2))
            assert a.dtype == np.float32 and a.shape == b.shape and a.shape[0] == frames(n), (sub, name)
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=f"{sub}/{name}")
            assert np.abs(b).max() > 1e-2


def test_batch_of_one_is_stage_10_and_the_loudest_file_keeps_its_units(tmp_path, checkpoints):
    """In a batch of one, every file's units are stage 10's
    (`process_units`, one file a call).  In a batch of four the Whisper
    log-mel's floor (its maximum - 8, `ops/stft.py::whisper_log_mel`) is
    taken over the whole batch, as in JAX (ROADMAP.md R8): the file that
    holds the batch's maximum keeps its units of a batch of one."""
    from latent_diffusion_speech_tpu_torch.cli.batch_preprocess import _buckets
    from latent_diffusion_speech_tpu_torch.cli.preprocess_unit import process_units
    from latent_diffusion_speech_tpu_torch.ops.audio_io import load_audio
    from latent_diffusion_speech_tpu_torch.ops.stft import whisper_log_mel

    units, _ = _port_encoders(checkpoints)
    trees = {b: _audio_tree(tmp_path / f"b{b}") for b in (1, 4)}
    for b, tree in trees.items():
        progress = list(batch_extract(tree, units, None, sample_rate=CODEC_SR, encoder_sr=SR, batch_size=b))
        assert len(progress) == (8 if b == 1 else 3)
    stage10 = _audio_tree(tmp_path / "stage10")
    assert len(list(process_units(stage10, units, SR, device_sr=SR))) == 8
    names = _npys(trees[1], "units")
    for name in names:
        np.testing.assert_allclose(np.load(trees[1] / "units" / name), np.load(stage10 / "units" / name),
                                   atol=1e-6, rtol=0, err_msg=name)

    audio = {n[:-4]: load_audio(trees[4] / "audio" / n[:-4], target_sr=SR)[0] for n in names}
    step = SR // 2
    for batch in _buckets({n: len(a) for n, a in audio.items()}, 4, step):
        pad = -(-max(len(audio[n]) for n in batch) // step) * step
        peaks = [whisper_log_mel(torch.from_numpy(np.pad(audio[n], (0, pad - len(audio[n])))),
                                 n_mels=WHISPER["n_mels"]).max().item()
                 for n in batch]
        loudest = batch[int(np.argmax(peaks))] + ".npy"
        np.testing.assert_allclose(np.load(trees[4] / "units" / loudest), np.load(trees[1] / "units" / loudest),
                                   atol=1e-6, rtol=0, err_msg=loudest)
