"""`CodecTrainer` in the port against the JAX package's, on the CPU.

One D step and one G step from the same weights (numpy draws on the JAX
trees, moved over with `convert.py`), audio and latent noise, with and
without the learned VQ: the losses at rtol 1e-5, every parameter after the
update at atol 1e-5 / rtol 1e-4, the VQ state at atol 1e-6.  The JAX
trainer is assembled around those trees (its own `__init__` would compile
three initialisers); its two steps compile as its `train_step` runs them.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latent_diffusion_speech_tpu.models.vaegan.discriminators import DiscriminatorBank as JDiscriminatorBank
from latent_diffusion_speech_tpu.models.vaegan.models import Generator as JGenerator
from latent_diffusion_speech_tpu.models.vaegan.models import VAEEncoder as JVAEEncoder
from latent_diffusion_speech_tpu.parallel.mesh import build_mesh
from latent_diffusion_speech_tpu.quantize import VectorQuantize as JVectorQuantize
from latent_diffusion_speech_tpu.train.codec_trainer import CodecTrainer as JCodecTrainer
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.train.codec_trainer import CodecTrainer
from tests.test_codec_trainer import TINY as J_TINY


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


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _draw(tree, g):
    """numpy draws on a tree of shapes: kernels LeCun-like, biases small."""
    def leaf(path, x):
        if path[-1].key == "bias":
            return (0.01 * g.standard_normal(x.shape)).astype(np.float32)
        return (g.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_trainer(tmp_path, use_vq):
    """The JAX `CodecTrainer` as its `__init__` builds it, around drawn trees."""
    g = np.random.default_rng(3)
    jt = JCodecTrainer.__new__(JCodecTrainer)
    jt.cfg, jt.mesh, jt.expdir = J_TINY, build_mesh(), str(tmp_path / "j")
    jt.kl_weight, jt.mel_weight, jt.fm_weight = 0.01, 45.0, 1.0
    jt.encoder, jt.generator = JVAEEncoder(J_TINY), JGenerator(J_TINY)
    jt.disc = JDiscriminatorBank(periods=TRAINER["disc_periods"], stft_scales=TRAINER["disc_scales"])
    jt.vq = JVectorQuantize(J_TINY.inter_channels, 32) if use_vq else None
    k = jax.random.PRNGKey(0)
    audio, z = jnp.zeros((1, J_TINY.hop_size * 4)), jnp.zeros((1, 4, J_TINY.inter_channels))
    shapes = {
        "encoder": jax.eval_shape(jt.encoder.init, {"params": k, "latent": k}, audio)["params"],
        "generator": jax.eval_shape(jt.generator.init, k, z)["params"],
    }
    jt.gen_params = jax.tree_util.tree_map(jnp.asarray, _draw(shapes, g))
    jt.disc_params = jax.tree_util.tree_map(
        jnp.asarray, _draw(jax.eval_shape(jt.disc.init, k, audio)["params"], g))
    jt.vq_state = jt.vq.init(jax.random.PRNGKey(4)) if use_vq else None
    if use_vq:  # a few codes in use, as after some steps
        jt.vq_state = jt.vq_state._replace(ema_counts=jnp.asarray(g.random(32).astype(np.float32)))
    jt.gen_tx = optax.adamw(2e-4, b1=0.8, b2=0.99)
    jt.disc_tx = optax.adamw(2e-4, b1=0.8, b2=0.99)
    jt.gen_opt, jt.disc_opt = jt.gen_tx.init(jt.gen_params), jt.disc_tx.init(jt.disc_params)
    jt.step = 0
    jt._gen_step, jt._disc_step = jt._build_steps()
    return jt


def _trainer_pair(tmp_path, use_vq):
    jt = _jax_trainer(tmp_path, use_vq)
    t = CodecTrainer(TINY, expdir=str(tmp_path / "t"), device="cpu", use_vq=use_vq, vq_codebook_size=32, **TRAINER)
    tree = jax.tree_util.tree_map(np.asarray, {"gen": jt.gen_params, "disc": jt.disc_params})
    t.encoder.load_state_dict(convert.encoder_from_jax(tree["gen"]["encoder"]))
    t.generator.load_state_dict(convert.generator_from_jax(tree["gen"]["generator"]))
    t.disc.load_state_dict(convert.discriminator_bank_from_jax(tree["disc"]))
    if use_vq:
        t.vq_state = convert.vq_state_from_jax(jt.vq_state)
    return jt, t


@pytest.mark.parametrize("use_vq", [False, True])
def test_disc_and_gen_steps_match_jax(tmp_path, rng, use_vq):
    """One alternating step from the same weights, audio and latent noise
    (JAX's draws replaced by the same numpy noise while its steps trace):
    the losses, then every parameter (and the VQ state) after the update."""
    jt, t = _trainer_pair(tmp_path, use_vq)
    audio = (rng.standard_normal((2, 512)) * 0.1).astype(np.float32)
    eps = [rng.standard_normal((2, 512 // TINY.hop_size, TINY.inter_channels)).astype(np.float32) for _ in range(2)]
    drawn = []

    def normal(key, shape, dtype=jnp.float32):
        drawn.append(tuple(shape))
        return jnp.asarray(eps[len(drawn) - 1], dtype)

    with mock.patch.object(jax.random, "normal", normal):
        want = jt.train_step(audio, jax.random.PRNGKey(0))
    assert drawn == [eps[0].shape, eps[1].shape]  # the D step's noise, then the G step's
    d_loss = t.disc_step(_t(audio), _t(eps[0]))
    g_loss, aux = t.gen_step(_t(audio), _t(eps[1]))
    np.testing.assert_allclose(d_loss.item(), want["disc/loss"], rtol=1e-5)
    np.testing.assert_allclose(g_loss.item(), want["gen/loss"], rtol=1e-5)
    for k, v in aux.items():
        np.testing.assert_allclose(v.item(), want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    tree = jax.tree_util.tree_map(np.asarray, {"gen": jt.gen_params, "disc": jt.disc_params})
    for module, state in ((t.encoder, convert.encoder_from_jax(tree["gen"]["encoder"])),
                          (t.generator, convert.generator_from_jax(tree["gen"]["generator"])),
                          (t.disc, convert.discriminator_bank_from_jax(tree["disc"]))):
        for name, p in module.state_dict().items():
            np.testing.assert_allclose(p.numpy(), state[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
    if use_vq:
        for name, v in convert.vq_state_from_jax(jt.vq_state)._asdict().items():
            np.testing.assert_allclose(getattr(t.vq_state, name).numpy(), v.numpy(), atol=1e-6, err_msg=name)
        assert t.vq.utilization(t.vq_state).item() > 0


