"""The trainers' options in the port against the JAX package, on the CPU.

* gradient accumulation (`gradient_accumulation_steps` k = 2) in both
  trainers against `optax.MultiSteps(chain, k)` over the same gradients,
  within 1e-6 (the rule of tests/test_torch_train.py's optimizer test), and
  an interrupted-between-micro-steps run equal, bit for bit, to an
  uninterrupted one;
* bf16 training (`dtype=torch.bfloat16`, f32 weights): the diffusion loss
  and gradients against the JAX `Unit2MelSystem(dtype=jnp.bfloat16)` the
  JAX `DiffusionTrainer(dtype=jnp.bfloat16)` builds, fed the same t and
  noise: loss rtol 5e-3, the gradients' global relative L2 error below 0.1
  and each tensor's below 0.3 (bf16 rounding noise: at this size the JAX
  bf16 gradients themselves differ from JAX's f32 ones by 5.5e-2 globally
  and up to 0.15 in a tensor); the weights and gradients stay f32; the LM
  trainer trains in bf16 too;
* `remat=True`: the same gradients, bit for bit;
* the learned VQ in the diffusion trainer (commitment loss, EMA state,
  sidecar), `train/mfu` and the card peak table, and `validate_full`'s
  spectrogram triptych and vocoder audio.
"""

import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelSystem as JUnit2MelSystem
from latent_diffusion_speech_tpu.train.schedule import warmup_step_decay as j_warmup_step_decay
from latent_diffusion_speech_tpu_torch.convert import unit2mel_from_jax
from latent_diffusion_speech_tpu_torch.data.lm_dataset import collate_text_batch
from latent_diffusion_speech_tpu_torch.data.loader import DataLoader
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, StackConfig
from latent_diffusion_speech_tpu_torch.quantize.codebook import VectorQuantize
from latent_diffusion_speech_tpu_torch.train.checkpoint import load_checkpoint_extra
from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer
from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer
from latent_diffusion_speech_tpu_torch.utils import flops
from latent_diffusion_speech_tpu_torch.utils.logger import MetricsLogger
from tests.test_torch_lm_train import _Items, _lm_config
from tests.test_torch_train import MEL_DIM, SMALL, TINY_MODEL, _DetDataset, _inputs, _port_loss, _tiny_config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small models: one intra-op thread (the parallel test run's workers
    would otherwise contend on every small op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY_LM = RoformerConfig(
    encoder=StackConfig(hidden_size=16, num_attention_heads=2, num_hidden_layers=1, intermediate_size=16),
    decoder=StackConfig(hidden_size=16, num_attention_heads=2, num_hidden_layers=1, intermediate_size=16),
    semantic_kmeans_num=16, n_spk=2,
)
COLLATE = partial(collate_text_batch, phone_pad=TINY_LM.phone_pad, semantic_pad=TINY_LM.semantic_pad, pad_multiple=8)


def _diffusion(tmp_path, k=1, save_opt=False, **kw):
    cfg = _tiny_config(tmp_path)
    cfg.diffusion.train.gradient_accumulation_steps = k
    cfg.diffusion.train.save_opt = save_opt
    return DiffusionTrainer(cfg, model_cfg=TINY_MODEL, device="cpu", **kw)


def _lm(tmp_path, k=1, save_opt=False, **kw):
    cfg = _lm_config(tmp_path, clip=1.0)
    cfg.common.n_spk = 2
    cfg.text2semantic.train.gradient_accumulation_steps = k
    cfg.text2semantic.train.save_opt = save_opt
    return LMTrainer(cfg, lm_cfg=TINY_LM, device="cpu", **kw)


def _diffusion_loader():
    return DataLoader(_DetDataset(), batch_size=4, shuffle=True, seed=9)


def _lm_loader():
    return DataLoader(_Items(), batch_size=4, collate=COLLATE, shuffle=True, seed=2)


# -- gradient accumulation -------------------------------------------------------


@pytest.mark.parametrize("kind", ["diffusion", "lm"])
def test_accumulation_matches_optax_multisteps(tmp_path, rng, kind):
    """Five calls with k = 2 from the same parameters and gradients (large
    enough to be clipped) against MultiSteps(chain(clip, adamw(schedule)), 2):
    the parameters after each call within 1e-6, unchanged between updates;
    the schedule counts updates."""
    trainer = (_diffusion if kind == "diffusion" else _lm)(tmp_path, k=2)
    tcfg = trainer._train_cfg()
    named = dict(trainer.system.module.named_parameters())
    params = {n: jnp.array(p.detach().numpy().copy()) for n, p in named.items()}
    tx = optax.MultiSteps(optax.chain(
        optax.clip_by_global_norm(tcfg.clip_grad_norm),
        optax.adamw(j_warmup_step_decay(tcfg.lr, tcfg.start_lr, tcfg.warm_up_steps, tcfg.decay_step, tcfg.gamma),
                    weight_decay=tcfg.weight_decay)), 2)
    state = tx.init(params)
    update = jax.jit(tx.update)
    for call in range(5):
        grads = {n: (3.0 * rng.standard_normal(p.shape)).astype(np.float32) for n, p in named.items()}
        before = {n: p.detach().clone() for n, p in named.items()}
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[n].copy())
        gnorm = trainer.apply_update()
        updates, state = update({n: jnp.asarray(g) for n, g in grads.items()}, state, params)
        params = jax.jit(optax.apply_updates)(params, updates)
        np.testing.assert_allclose(gnorm.item(), float(optax.global_norm(grads)), rtol=1e-6)
        assert (trainer.mini_step, trainer.opt_count) == (int(state.mini_step), int(state.gradient_step))
        for n, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), atol=1e-6, rtol=0, err_msg=n)
            if call % 2 == 0:
                assert torch.equal(p, before[n]), n
    assert trainer.optimizer.param_groups[0]["lr"] == trainer.schedule(1)


@pytest.mark.parametrize("kind", ["diffusion", "lm"])
def test_run_interrupted_between_micro_steps_matches_uninterrupted(tmp_path, kind):
    """k = 2, the optimizer state saved: 5 micro-steps in one go against 3
    (the third half-way through an update), a save, a fresh trainer's resume
    and 2 more; every parameter bit for bit, and the accumulator restored."""
    make, loader = (_diffusion, _diffusion_loader) if kind == "diffusion" else (_lm, _lm_loader)
    t_a = make(tmp_path / "a", k=2, save_opt=True)
    t_a.train(loader(), max_steps=5)
    make(tmp_path / "b", k=2, save_opt=True).train(loader(), max_steps=3)
    t_b = make(tmp_path / "b", k=2, save_opt=True)
    assert t_b.resume()
    assert (t_b.step, t_b.mini_step, t_b.opt_count) == (3, 1, 1) and t_b._acc is not None
    t_b.train(loader(), max_steps=5)
    assert t_a.step == t_b.step == 5 and t_a.opt_count == t_b.opt_count == 2
    for (name, a), b in zip(t_a.system.module.named_parameters(), t_b.system.module.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(t_a._acc, t_b._acc):
        assert torch.equal(a, b)


# -- bf16 and remat ----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_bf16():
    return JUnit2MelSystem(JUnit2MelConfig(**SMALL), dtype=jnp.bfloat16, seed=0)


def _j_loss_fn(jsys):
    def j_loss(params, units, spec, spk, aug, t, noise):
        d = jsys.diffusion
        cond = jsys.condition(units, None, spk, aug, params=params)
        x_noisy = d.q_sample(d.norm_spec(spec), t, noise)
        x_noisy, cond, T = d._pad(x_noisy, cond)
        eps = d._eps_fn(params, cond)(x_noisy, t)[:, :T]
        return jnp.mean((noise - eps) ** 2)
    return j_loss


def _port_inputs(a):
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    ta["spk"], ta["t"] = ta["spk"].long(), ta["t"].long()
    return ta


@pytest.mark.parametrize("remat", [False, True])
def test_bf16_loss_and_gradients_match_jax(tmp_path, rng, jax_bf16, remat):
    a = _inputs(rng)
    ref, j_grads = jax.jit(jax.value_and_grad(_j_loss_fn(jax_bf16)))(
        jax_bf16.params, *(jnp.asarray(a[k]) for k in ("units", "spec", "spk", "aug", "t", "noise")))
    cfg = _tiny_config(tmp_path)
    trainer = DiffusionTrainer(cfg, model_cfg=Unit2MelConfig(**SMALL), dtype=torch.bfloat16, remat=remat,
                               device="cpu")
    trainer.system.module.load_state_dict(unit2mel_from_jax(jax.tree_util.tree_map(np.asarray, jax_bf16.params)))
    loss = _port_loss(trainer.system, _port_inputs(a), None)
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(ref), rtol=5e-3)
    want = unit2mel_from_jax(jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), j_grads))
    err2 = ref2 = 0.0
    for name, p in trainer.system.module.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        rel = ((p.grad - want[name]).norm() / want[name].norm().clamp_min(1e-12)).item()
        assert rel < 0.3, (name, rel)
        err2, ref2 = err2 + ((p.grad - want[name]) ** 2).sum().item(), ref2 + (want[name] ** 2).sum().item()
    assert (err2 / ref2) ** 0.5 < 0.1


def test_remat_gives_the_same_gradients(tmp_path, rng):
    """The flagship UNet with and without remat, the same weights, t and
    noise: equal losses and gradients (remat changes memory, not numbers)."""
    a = _port_inputs(_inputs(rng))
    grads = []
    for remat in (False, True):
        trainer = DiffusionTrainer(_tiny_config(tmp_path), model_cfg=Unit2MelConfig(**SMALL), remat=remat,
                                   device="cpu")
        assert trainer.system.module.unet.cfg.remat == remat
        loss = _port_loss(trainer.system, a, None)
        loss.backward()
        grads.append((loss.item(), {n: p.grad for n, p in trainer.system.module.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    assert l0 == l1 and g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_lm_trainer_trains_in_bf16(tmp_path):
    """`LMTrainer(dtype=torch.bfloat16)` (dropout off) against the f32
    trainer from the same seed and batch: the loss within rtol 2e-2 and
    the gradients' global relative L2 error below 0.1; the weights and
    gradients stay f32, and the step moves them."""
    off = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    lm_cfg = dataclasses.replace(TINY_LM, encoder=dataclasses.replace(TINY_LM.encoder, **off),
                                 decoder=dataclasses.replace(TINY_LM.decoder, **off))
    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        cfg = _lm_config(tmp_path, clip=1.0)
        cfg.common.n_spk = 2
        trainer = LMTrainer(cfg, lm_cfg=lm_cfg, dtype=dtype, device="cpu")
        before = [p.detach().clone() for p in trainer.system.module.parameters()]
        loss = trainer.train_step(trainer.device_put_batch(next(iter(_lm_loader()))))["loss"].item()
        grads = {n: p.grad for n, p in trainer.system.module.named_parameters()}
        runs.append((loss, grads, trainer, before))
    (loss, grads, _, _), (loss16, grads16, trainer, before) = runs
    assert trainer.system.module.dtype == torch.bfloat16
    np.testing.assert_allclose(loss16, loss, rtol=2e-2)
    err = sum(((grads16[n] - g) ** 2).sum() for n, g in grads.items()) ** 0.5
    assert (err / sum((g ** 2).sum() for g in grads.values()) ** 0.5).item() < 0.1
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in trainer.system.module.parameters())
    assert any(not torch.equal(p, b) for p, b in zip(trainer.system.module.parameters(), before))


# -- the learned VQ, MFU and validation ----------------------------------------------


def test_learned_vq_trains_jointly_and_writes_its_sidecar(tmp_path):
    vq = VectorQuantize(TINY_MODEL.input_channel, 32)
    trainer = _diffusion(tmp_path, quantizer=vq)
    assert trainer.vq_state.codebook.shape == (32, 32) and not any(isinstance(t, torch.nn.Parameter)
                                                                    for t in trainer.vq_state)
    batch = trainer.device_put_batch({k: np.stack([it[k] for it in _DetDataset(n=4).items])
                                      for k in ("units", "mel", "spk_id")})
    state0 = trainer.vq_state
    units, _, commit, _ = vq(state0, batch["units"], train=True)
    want = trainer.system.loss(units, batch["mel"], torch.Generator().manual_seed(3),
                               spk_id=batch["spk_id"]) + commit
    got = trainer.train_step(batch, torch.Generator().manual_seed(3))["loss"]
    assert got.item() == want.item() and commit.item() > 0
    assert not torch.equal(trainer.vq_state.codebook, state0.codebook)
    assert vq.utilization(trainer.vq_state).item() > 0
    # the projections are state: the optimizer does not hold them
    assert {id(p) for p in trainer._params}.isdisjoint({id(t) for t in trainer.vq_state})
    trainer.save()
    side = torch.load(tmp_path / "exp_diff" / "model_1_semantic_codebook.ckpt", weights_only=True)
    assert all(torch.equal(side[k], v) for k, v in trainer.vq_state._asdict().items())
    assert load_checkpoint_extra(tmp_path / "exp_diff", "ema") is None


def test_mfu_is_logged_from_the_step_flops(tmp_path, monkeypatch):
    """With a known peak, `train` logs train/mfu = FLOPs x steps/s / peak,
    the FLOPs counted once per batch shape; on the CPU (no peak) none."""
    from torch.utils.flop_counter import FlopCounterMode

    logged = []

    class Log:
        def log(self, step, metrics):
            logged.append(metrics)

    trainer = _diffusion(tmp_path)
    trainer.cfg.diffusion.train.interval_log = 1
    trainer.train(_diffusion_loader(), max_steps=1, logger=Log())
    assert "train/mfu" not in logged[-1]  # the CPU: no peak
    monkeypatch.setattr(flops, "device_peak_flops", lambda device: 1e12)
    trainer = _diffusion(tmp_path / "b")
    trainer.cfg.diffusion.train.interval_log = 1
    trainer.train(_diffusion_loader(), max_steps=2, logger=Log())
    batch = trainer.device_put_batch(next(iter(_diffusion_loader())))
    with FlopCounterMode(display=False) as counter:
        trainer.train_step(batch, torch.Generator().manual_seed(0))
    step_flops = counter.get_total_flops()
    assert step_flops > 0
    for m in logged[-2:]:
        np.testing.assert_allclose(m["train/mfu"], step_flops * m["train/steps_per_sec"] / 1e12, rtol=1e-9)


def test_card_peak_table(monkeypatch):
    assert flops.device_peak_flops("cpu") is None
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12), ("NVIDIA A100-SXM4", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device, n=name: n)
        assert flops.device_peak_flops("cuda") == peak


def test_lm_logs_mfu_with_a_known_peak(tmp_path, monkeypatch):
    monkeypatch.setattr(flops, "device_peak_flops", lambda device: 1e12)
    trainer = _lm(tmp_path)
    trainer.cfg.text2semantic.train.interval_log = 1
    logger = MetricsLogger(tmp_path / "lm_logs", use_tensorboard=False)
    trainer.train(_lm_loader(), max_steps=2, logger=logger)
    logger.close()
    rows = [json.loads(x) for x in (tmp_path / "lm_logs" / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and all(r["train/mfu"] > 0 for r in rows)


def test_validate_full_writes_the_triptych_and_the_audio(tmp_path):
    class Vocoder:
        vocoder_sample_rate = 8000

        def infer(self, mel):
            return mel.reshape(1, -1)

    trainer = _diffusion(tmp_path)
    trainer.cfg.common.infer.method, trainer.cfg.common.infer.speedup = "dpm-solver", 5
    logger = MetricsLogger(tmp_path / "logs_dir", use_tensorboard=False)
    metrics = trainer.validate_full(DataLoader(_DetDataset(), batch_size=4, shuffle=False),
                                    torch.Generator().manual_seed(0), logger=logger, vocoder=Vocoder())
    logger.close()
    assert set(metrics) == {"val/loss", "val/mel_abs_err"}
    spec = np.load(tmp_path / "logs_dir" / "logs" / "spec" / "val_spec_0.npz")
    assert spec["gt"].shape == spec["pred"].shape == (MEL_DIM, 16)
    np.testing.assert_allclose(spec["abs_err"], np.abs(spec["pred"] - spec["gt"]))
    np.testing.assert_allclose(spec["gt"], _DetDataset().items[0]["mel"].T)
    assert (tmp_path / "logs_dir" / "logs" / "audio" / "val_audio_0.wav").stat().st_size > 44
