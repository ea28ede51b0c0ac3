"""Codec-training pieces of the port against the JAX package, on the CPU.

* the six losses against `models/vaegan/losses.py`, and the discriminator
  bank's logits and feature maps against the flax bank and a torch
  restatement of the reference bank (tests/test_discriminators.py's), the
  weights read by both importers; `convert.discriminator_bank_from_jax` of
  the flax tree equals the port's importer;
* `CodecTrainer` save / resume, and `cli/train_codec.py::main` for two
  steps on a tiny layout, then a resumed `--use-vq` step.
Tolerances: losses and the bank rtol 2e-4 / atol 2e-5 (the tolerance of
tests/test_discriminators.py).  The trainer's steps against JAX's:
tests/test_torch_codec_train.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.vaegan import losses as j_losses
from latent_diffusion_speech_tpu.models.vaegan.discriminators import DiscriminatorBank as JDiscriminatorBank
from latent_diffusion_speech_tpu.models.vaegan.import_torch import (
    discriminator_bank_params_from_torch as j_bank_params_from_torch,
)
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.models.vaegan import losses
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vaegan.discriminators import DiscriminatorBank
from latent_diffusion_speech_tpu_torch.models.vaegan.import_torch import discriminator_bank_params_from_torch
from latent_diffusion_speech_tpu_torch.train.checkpoint import latest_checkpoint_step
from latent_diffusion_speech_tpu_torch.train.codec_trainer import CodecTrainer
from tests.test_codec_trainer import TINY as J_TINY
from tests.test_discriminators import PERIODS, SCALES, TorchBank


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small models: one intra-op thread (the parallel test run's workers
    would otherwise contend on every small op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = VAEGANConfig(**dataclasses.asdict(J_TINY))
TRAINER = dict(disc_scales=((128, 32, 128),), disc_periods=(2,))
RTOL, ATOL = 2e-4, 2e-5


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _logit_sets(rng, n=3):
    return [rng.standard_normal((2, 7 + i, 3)).astype(np.float32) for i in range(n)]


@pytest.mark.parametrize("name", ["discriminator_loss", "generator_loss", "feature_loss", "kl_loss", "sss_loss",
                                  "rss_loss"])
def test_losses_match_jax(rng, name):
    real, fake = _logit_sets(rng), _logit_sets(rng)
    wav_a, wav_b = (0.3 * rng.standard_normal((2, 2048))).astype(np.float32), (0.3 * rng.standard_normal(
        (2, 2048))).astype(np.float32)
    args = {
        "discriminator_loss": (real, fake),
        "generator_loss": (fake,),
        "feature_loss": ([real, fake], [fake, real]),
        "kl_loss": (0.5 * rng.standard_normal((2, 9, 4)).astype(np.float32),
                    rng.standard_normal((2, 9, 4)).astype(np.float32)),
        "sss_loss": (wav_a, wav_b, 256),
        "rss_loss": (wav_a, wav_b, (64, 512, 4096)),
    }[name]
    to_j = lambda a: jax.tree_util.tree_map(jnp.asarray, a) if not isinstance(a, int) else a  # noqa: E731
    to_t = lambda a: a if isinstance(a, (int, tuple)) else (  # noqa: E731
        [to_t(x) for x in a] if isinstance(a, list) else _t(a))
    want = getattr(j_losses, name)(*(a if isinstance(a, tuple) else to_j(a) for a in args))
    got = getattr(losses, name)(*(to_t(a) for a in args))
    if isinstance(want, tuple):  # (total, per discriminator)
        np.testing.assert_allclose(np.asarray(jax.tree_util.tree_leaves(want[1])),
                                   [t.item() for t in jax.tree_util.tree_leaves(got[1])], rtol=RTOL, atol=ATOL)
        want, got = want[0], got[0]
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)


def test_rss_loss_needs_a_usable_scale():
    with pytest.raises(ValueError, match="no usable FFT scale"):
        losses.rss_loss(torch.zeros(1, 100), torch.zeros(1, 100), scales=(128,))


@pytest.fixture(scope="module")
def banks():
    torch.manual_seed(0)
    ref = TorchBank(PERIODS, SCALES).eval()
    jparams = jax.tree_util.tree_map(
        np.asarray, j_bank_params_from_torch(ref.state_dict(), periods=PERIODS, n_stft_scales=len(SCALES)))
    state = discriminator_bank_params_from_torch(ref.state_dict(), periods=PERIODS, n_stft_scales=len(SCALES))
    bank = DiscriminatorBank(periods=PERIODS, stft_scales=SCALES).eval()
    bank.load_state_dict(state)
    return ref, JDiscriminatorBank(periods=PERIODS, stft_scales=SCALES), jparams, state, bank


def test_bank_importers_agree(banks):
    """The port's importer equals the JAX importer followed by
    `convert.discriminator_bank_from_jax`, bit for bit."""
    _, _, jparams, state, bank = banks
    via_jax = convert.discriminator_bank_from_jax(jparams)
    assert via_jax.keys() == state.keys() == bank.state_dict().keys()
    for k, v in state.items():
        assert torch.equal(v, via_jax[k]), k


@pytest.mark.parametrize("oracle", ["flax", "reference"])
def test_bank_logits_and_fmaps_match(banks, rng, oracle):
    ref, jbank, jparams, _, bank = banks
    wav = (rng.standard_normal((2, 2048)) * 0.3).astype(np.float32)
    with torch.no_grad():
        got_logits, got_fmaps = bank(_t(wav))
        if oracle == "reference":
            want_logits, want_fmaps = ref(_t(wav)[:, None])
            want_logits = [x.numpy() for x in want_logits]
            want_fmaps = [[x.numpy() for x in fm] for fm in want_fmaps]
    if oracle == "flax":
        want_logits, want_fmaps = jbank.apply({"params": jparams}, jnp.asarray(wav))
        # flax is channels-last: logits (B, T', F', 1) and fmaps (B, ..., C)
        want_logits = [np.moveaxis(np.asarray(x), -1, 1) if x.ndim == 4 else np.asarray(x) for x in want_logits]
        want_fmaps = [[np.moveaxis(np.asarray(x), -1, 1) for x in fm] for fm in want_fmaps]
    assert len(got_logits) == len(want_logits) == len(SCALES) + 1 + len(PERIODS)
    for i, (g, w) in enumerate(zip(got_logits, want_logits)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=f"logit {i}")
    for i, (gf, wf) in enumerate(zip(got_fmaps, want_fmaps)):
        assert len(gf) == len(wf)
        for j, (g, w) in enumerate(zip(gf, wf)):
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=f"fmap {i}.{j}")


def test_train_step_saves_and_resumes(tmp_path, rng):
    t = CodecTrainer(TINY, expdir=str(tmp_path / "c"), device="cpu", **TRAINER)
    audio = (rng.standard_normal((2, 512)) * 0.1).astype(np.float32)
    m = [t.train_step(audio, torch.Generator().manual_seed(s)) for s in (0, 1)]
    assert t.step == 2 and all(np.isfinite(v) for x in m for v in x.values())
    assert all(x["gen/kl"] >= -1e-5 and x["gen/mel"] >= 0 for x in m)
    t.save()
    t2 = CodecTrainer(TINY, expdir=str(tmp_path / "c"), device="cpu", seed=1, **TRAINER)
    assert t2.resume() and t2.step == 2
    for a, b in ((t.encoder, t2.encoder), (t.generator, t2.generator), (t.disc, t2.disc)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), name
    t2.expdir = str(tmp_path / "none")
    assert not t2.resume()


def test_cli_trains_two_steps_on_a_layout(tmp_path, monkeypatch):
    """`cli/train_codec.py::main` on two WAVs at 8 kHz with the tiny codec
    and bank:
    two steps, the metrics log and the checkpoint; with --use-vq, the
    resumed run goes on to step 3."""
    from latent_diffusion_speech_tpu_torch.cli import train_codec
    from latent_diffusion_speech_tpu_torch.config import Config, save_config
    from latent_diffusion_speech_tpu_torch.models.vaegan import config as vaegan_config
    from latent_diffusion_speech_tpu_torch.ops.audio_io import write_wav

    g = np.random.default_rng(0)
    for n, sec in enumerate((0.4, 0.05)):  # one longer than the crop, one shorter
        (tmp_path / "train" / "audio").mkdir(parents=True, exist_ok=True)
        write_wav(tmp_path / "train" / "audio" / f"{n}.wav", 0.1 * g.standard_normal(int(8000 * sec)), 8000)
    cfg = Config()
    cfg.data.train_path, cfg.data.sampling_rate = str(tmp_path / "train"), 8000
    save_config(cfg, tmp_path / "config.yaml")
    from latent_diffusion_speech_tpu_torch.train import codec_trainer

    monkeypatch.setattr(vaegan_config, "VAEGANConfig",
                        lambda sampling_rate: dataclasses.replace(TINY, sampling_rate=sampling_rate))
    # the small bank (one STFT scale, one period); the shipped one runs on the card (chip_smoke.py)
    monkeypatch.setattr(codec_trainer, "CodecTrainer", functools.partial(CodecTrainer, **TRAINER))
    expdir = tmp_path / "codec"
    args = ["-c", str(tmp_path / "config.yaml"), "--expdir", str(expdir), "--batch-size", "2", "--crop-sec", "0.066",
            "--interval-log", "1", "--device", "cpu"]
    trainer = train_codec.main(args + ["--max-steps", "2"])
    assert trainer.step == 2 and latest_checkpoint_step(expdir) == 2
    lines = (expdir / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and '"disc/loss"' in lines[0]
    trainer = train_codec.main(args + ["--max-steps", "3", "--use-vq"])
    assert trainer.step == 3 and trainer.vq is not None and latest_checkpoint_step(expdir) == 3
