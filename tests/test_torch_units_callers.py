"""The callers of `cfg.data.encoder` with each of the three other encoders.

On the CPU, the shipped config with `data.encoder` set to `hubert_soft`
(bshall's layout, written here), `xlsr_53_56k` or `w2v-bert` (seeded, one
layer at the 1024 width the config gives their units), a tiny diffusion
model and vocoder: stage 10 writes units of the encoder's width, stage 17
fits a codebook over them, stage 19 tokenises them with it,
`cli/batch_preprocess.py` writes units and latents, stage 18 writes the
validation set's units, and `cli/infer_svc.py` converts a clip through a
`Unit2Mel` whose input width is `get_encoder_out_channels`.  Parity with
the JAX package is held by tests/test_torch_units_alt.py and
tests/test_torch_units_w2v.py; this file shows the stream reaching every
stage.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu_torch import config
from latent_diffusion_speech_tpu_torch.cli import (
    batch_preprocess,
    infer_svc,
    preprocess_cluster,
    preprocess_token,
    preprocess_unit,
    preprocess_val,
)
from latent_diffusion_speech_tpu_torch.models import units as port_units
from latent_diffusion_speech_tpu_torch.models.units import get_encoder_out_channels
from latent_diffusion_speech_tpu_torch.models.vaegan import config as vaegan_config
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.w2vbert import W2vBertConfig
from latent_diffusion_speech_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from latent_diffusion_speech_tpu_torch.ops import audio_io
from latent_diffusion_speech_tpu_torch.quantize.kmeans import kmeans_predict, load_codebook
from tests.test_torch_units_alt import BshallHubert

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "config.yaml"
VAEGAN = dict(sampling_rate=8000, inter_channels=6, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
              upsample_rates=(8, 8), upsample_initial_channel=16, upsample_kernel_sizes=(16, 16))


@pytest.fixture(scope="module")
def hubert_ckpt(tmp_path_factory):
    torch.manual_seed(0)
    path = tmp_path_factory.mktemp("hubert") / "hubert-soft.pt"
    torch.save({"hubert": BshallHubert().state_dict()}, path)
    return path


def _wavs(root, n, seed=0, text=False):
    rng = np.random.default_rng(seed)
    for i in range(n):
        path = root / "audio" / f"spk{i % 2}" / f"f{i}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        t = np.arange(int((0.9 + 0.3 * i) * 16000)) / 16000
        wav = 0.2 * np.sin(2 * np.pi * (150 + 20 * i) * t) + 0.01 * rng.standard_normal(t.size)
        audio_io.write_wav(path, wav.astype(np.float32), 16000)
    if text:
        for spk in ("spk0", "spk1"):
            stems = sorted(p.stem for p in (root / "audio" / spk).glob("*.wav"))
            (root / "audio" / spk / "utt_text.txt").write_text("".join(f"{s}|Hello world.\n" for s in stems))


@pytest.mark.parametrize("encoder", ["hubert_soft", "xlsr_53_56k", "w2v-bert"])
def test_each_caller_runs_with_the_encoder(encoder, tmp_path, hubert_ckpt, monkeypatch):
    width = get_encoder_out_channels(encoder)
    monkeypatch.setattr(vaegan_config, "VAEGANConfig", lambda: VAEGANConfig(**VAEGAN))
    monkeypatch.setattr(port_units, "Wav2Vec2Config", lambda: Wav2Vec2Config(
        num_hidden_layers=1, intermediate_size=64, conv_dim=(32,) * 7))
    monkeypatch.setattr(port_units, "W2vBertConfig", lambda: W2vBertConfig(num_hidden_layers=1, intermediate_size=64))
    cfg = config.load_config(CONFIG)
    cfg.data.encoder = encoder
    cfg.common.n_spk = 4
    cfg.common.vocoder.ckpt = str(tmp_path / "no-vocoder")
    m = cfg.diffusion.model
    m.block_out_channels, m.n_heads, m.n_hidden, m.n_layers, m.out_dims = (8, 8), 2, 8, 1, 6
    lm = cfg.text2semantic.model
    lm.codebook_path, lm.semantic_kmeans_num = str(tmp_path / "codebook.npz"), 16
    cfg.data.train_path, cfg.data.valid_path = str(tmp_path / "train"), str(tmp_path / "val")
    path = str(tmp_path / "tiny.yaml")
    config.save_config(cfg, path)
    ckpt = str(hubert_ckpt) if encoder == "hubert_soft" else str(tmp_path / "no-encoder.pt")
    common = ["-c", path, "--device", "cpu"]
    _wavs(tmp_path / "train", 4)
    _wavs(tmp_path / "val", 2, seed=1, text=True)

    preprocess_unit.main([*common, "--ckpt", ckpt])  # stage 10
    unit_files = sorted((tmp_path / "train" / "units").rglob("*.npy"))
    units = {f: np.load(f) for f in unit_files}
    assert len(units) == 4 and all(u.shape[1] == width and np.isfinite(u).all() for u in units.values())
    # 50 fps; XLSR's unpadded convolutions give one frame fewer when a file
    # fills its half-second bucket exactly (as in JAX)
    frames = sorted(u.shape[0] for u in units.values())
    assert all(0 <= int((0.9 + 0.3 * i) * 16000) // 320 - f <= 1 for i, f in enumerate(frames))

    preprocess_cluster.main(common)  # stage 17
    codebook = load_codebook(lm.codebook_path)
    assert codebook.shape == (16, width)
    preprocess_token.main(common)  # stage 19
    for f, u in units.items():
        ids = np.load(tmp_path / "train" / "semantic_token" / f.relative_to(tmp_path / "train" / "units"))
        np.testing.assert_array_equal(ids, kmeans_predict(u, codebook).numpy())

    batch_preprocess.main([*common, "--ckpt", ckpt, "--batch-size", "2"])
    assert all(np.load(f).shape == u.shape for f, u in units.items())  # rewritten, same frames and width
    assert len(list((tmp_path / "train" / "mel").rglob("*.npy"))) == 4

    preprocess_val.main([*common, "--ckpt", ckpt, "--language", "EN"])  # stage 18
    val_units = sorted((tmp_path / "val" / "units").rglob("*.npy"))
    assert len(val_units) == 2 and all(np.load(f).shape[1] == width for f in val_units)

    src, out = tmp_path / "in.wav", tmp_path / "out.wav"
    audio_io.write_wav(src, np.concatenate([np.zeros(4800, np.float32), audio_io.read_wav(
        tmp_path / "train" / "audio" / "spk0" / "f0.wav")[0]]), 16000)
    infer_svc.main([*common, "-i", str(src), "-o", str(out), "--speedup", "250", "--units-ckpt", ckpt])
    wav, sr = audio_io.read_wav(out)
    assert sr == 8000 and np.isfinite(wav).all() and abs(len(wav) - (4800 + 14400) / 2) <= 64
