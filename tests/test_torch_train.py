"""Diffusion training in the port against the JAX package.

f32 on the CPU, inputs made with numpy from a seed, parameters moved over
with `convert.unit2mel_from_jax`.  Tolerances:
* loss rtol 1e-5; every parameter gradient atol 1e-5, rtol 1e-4 against
  `jax.grad` of the JAX composition (condition -> q_sample -> pad ->
  denoiser -> crop -> mean squared error), both fed the same t and noise;
* optimizer updates (global-norm clip + AdamW + warmup/step-decay) within
  1e-6 of optax from the same parameters and gradients;
* an interrupted and resumed run equals an uninterrupted one bitwise
  (tests/test_resume_determinism.py is the spec).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelSystem as JUnit2MelSystem
from latent_diffusion_speech_tpu.train.schedule import warmup_step_decay as j_warmup_step_decay
from latent_diffusion_speech_tpu_torch.cli.train_diffusion import build
from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.convert import unit2mel_from_jax
from latent_diffusion_speech_tpu_torch.data.loader import DataLoader
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.quantize.codebook import EuclideanCodebook
from latent_diffusion_speech_tpu_torch.train.checkpoint import (
    latest_checkpoint_step,
    load_checkpoint,
    load_checkpoint_meta,
    save_checkpoint,
)
from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer, step_generator
from latent_diffusion_speech_tpu_torch.train.schedule import warmup_step_decay

SMALL = dict(input_channel=12, n_spk=4, out_dims=6, n_hidden=10, block_out_channels=(16, 32),
             n_heads=2, timesteps=100, k_step=100)
UNIT_DIM, MEL_DIM = 8, 4
TINY_MODEL = Unit2MelConfig(input_channel=UNIT_DIM, n_spk=4, out_dims=MEL_DIM, n_hidden=8,
                            block_out_channels=(8, 8), n_heads=2, timesteps=20, k_step=20)


def _layout(root, rng, unit_dim=UNIT_DIM, speakers=("1", "2"), files=3):
    """Synthetic data/train layout (tests/test_train.py's): mel stats
    (T, 2 * MEL_DIM) and units (T // 2, unit_dim) per file."""
    for spk in speakers:
        for n in range(files):
            (root / "audio" / spk).mkdir(parents=True, exist_ok=True)
            (root / "audio" / spk / f"{n}.wav").write_bytes(b"")
            T = 100 + n * 10
            for kind, arr in [
                ("mel", rng.standard_normal((T, 2 * MEL_DIM)).astype(np.float32)),
                ("aug_mel", rng.standard_normal((T, 2 * MEL_DIM)).astype(np.float32)),
                ("units", rng.standard_normal((T // 2, unit_dim)).astype(np.float32)),
            ]:
                (root / kind / spk).mkdir(parents=True, exist_ok=True)
                np.save(root / kind / spk / f"{n}.wav.npy", arr)
    return root


def _tiny_config(tmp_path) -> Config:
    cfg = Config()
    cfg.common.n_spk = 4
    cfg.diffusion.train.batch_size = 4
    cfg.diffusion.train.expdir = str(tmp_path / "exp_diff")
    cfg.diffusion.train.warm_up_steps = 2
    cfg.diffusion.train.interval_log = 10_000
    cfg.diffusion.train.interval_val = 10_000
    cfg.data.block_size = 2
    cfg.data.sampling_rate = 100  # 1 s crop => 50 frames
    return cfg


class _DetDataset:
    """Deterministic items (tests/test_resume_determinism.py's)."""

    def __init__(self, n=12, T=16):
        g = np.random.default_rng(0)
        self.items = [
            {
                "units": g.standard_normal((T, UNIT_DIM)).astype(np.float32),
                "mel": g.standard_normal((T, MEL_DIM)).astype(np.float32),
                "spk_id": np.array([1 + (i % 2)], np.int32),
            }
            for i in range(n)
        ]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


# -- the loss and its gradients ------------------------------------------------


def _pair(**kw):
    jsys = JUnit2MelSystem(JUnit2MelConfig(**SMALL, **kw), seed=0)
    state = unit2mel_from_jax(jax.tree_util.tree_map(np.asarray, jsys.params))
    return jsys, Unit2MelSystem(Unit2MelConfig(**SMALL, **kw), state_dict=state, device="cpu")


def _inputs(rng, B=2, T=13):
    return dict(
        units=rng.standard_normal((B, T, SMALL["input_channel"])).astype(np.float32),
        spec=rng.standard_normal((B, T, SMALL["out_dims"])).astype(np.float32),
        volume=rng.random((B, T)).astype(np.float32),
        spk=np.array([[1], [3]], np.int32),
        aug=rng.standard_normal((B, 1)).astype(np.float32),
        t=np.array([3, 71], np.int32),
        noise=rng.standard_normal((B, T, SMALL["out_dims"])).astype(np.float32),
    )


def _port_loss(sys_, a, volume):
    """The port's composition, the parts `p_losses` runs."""
    d = sys_.diffusion
    cond = sys_.module.condition(a["units"], volume, a["spk"], a["aug"])
    x_noisy = d.q_sample(d.norm_spec(a["spec"]), a["t"], a["noise"])
    x_noisy, cond, T = d._pad(x_noisy, cond)
    eps = d.denoise_fn(None, torch.cat([x_noisy, cond], dim=-1), a["t"])[:, :T]
    return ((a["noise"] - eps) ** 2).mean()


@pytest.mark.parametrize("is_tts", [True, False])
def test_loss_and_gradients_match_jax(rng, is_tts):
    """From the same weights, t and noise: the loss and the gradient of
    every parameter (is_tts=False also conditions on volume)."""
    jsys, sys_ = _pair(is_tts=is_tts)
    a = _inputs(rng)
    vol = None if is_tts else a["volume"]

    def j_loss(params, units, spec, volume, spk, aug, t, noise):
        d = jsys.diffusion
        cond = jsys.condition(units, volume, spk, aug, params=params)
        x_noisy = d.q_sample(d.norm_spec(spec), t, noise)
        x_noisy, cond, T = d._pad(x_noisy, cond)
        eps = d._eps_fn(params, cond)(x_noisy, t)[:, :T]
        return jnp.mean((noise - eps) ** 2)

    ref, j_grads = jax.jit(jax.value_and_grad(j_loss))(
        jsys.params, *(None if v is None else jnp.asarray(v)
                       for v in (a["units"], a["spec"], vol, a["spk"], a["aug"], a["t"], a["noise"])))
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    ta["spk"], ta["t"] = ta["spk"].long(), ta["t"].long()
    loss = _port_loss(sys_, ta, None if is_tts else ta["volume"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    want = unit2mel_from_jax(jax.tree_util.tree_map(np.asarray, j_grads))
    got = {n: p.grad for n, p in sys_.module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("loss_type", ["l2", "l1"])
def test_p_losses_draws_t_then_noise_from_the_generator(rng, loss_type):
    _, sys_ = _pair()
    a = {k: torch.from_numpy(v) for k, v in _inputs(rng).items()}
    cond = sys_.module.condition(a["units"], None, a["spk"].long(), a["aug"])
    got = sys_.diffusion.p_losses(a["spec"], cond, torch.Generator().manual_seed(5), loss_type=loss_type)
    g = torch.Generator().manual_seed(5)
    t = torch.randint(0, SMALL["k_step"], (2,), generator=g)
    noise = torch.randn(a["spec"].shape, generator=g)
    d = sys_.diffusion
    x_noisy, cond_p, T = d._pad(d.q_sample(d.norm_spec(a["spec"]), t, noise), cond)
    err = noise - d.denoise_fn(None, torch.cat([x_noisy, cond_p], dim=-1), t)[:, :T]
    want = err.abs().mean() if loss_type == "l1" else (err**2).mean()
    assert got.item() == want.item()
    system_loss = sys_.loss(a["units"], a["spec"], torch.Generator().manual_seed(5), spk_id=a["spk"].long(),
                            aug_shift=a["aug"])
    if loss_type == "l2":
        assert system_loss.item() == got.item()


# -- the optimizer ---------------------------------------------------------------


def test_learning_rate_schedule_matches_jax():
    kw = dict(lr=1.5e-4, start_lr=1e-5, warm_up_steps=5, decay_step=7, gamma=0.5)
    mine, theirs = warmup_step_decay(**kw), j_warmup_step_decay(**kw)
    for step in range(kw["warm_up_steps"] + 2 + 10):
        np.testing.assert_allclose(mine(step), float(theirs(jnp.asarray(step))), rtol=1e-6)


@pytest.mark.parametrize("scale,weight_decay", [(50.0, 0.0), (1e-3, 0.01)])
def test_optimizer_steps_match_optax(tmp_path, rng, scale, weight_decay):
    """Three updates from the same parameters and gradients (the first
    clipped when scale is large) against optax.chain(clip_by_global_norm,
    adamw(warmup_step_decay)), within 1e-6; the rate of update k is the
    schedule at k."""
    cfg = _tiny_config(tmp_path)
    cfg.diffusion.train.weight_decay = weight_decay
    tcfg = cfg.diffusion.train
    trainer = DiffusionTrainer(cfg, model_cfg=TINY_MODEL, device="cpu")
    named = dict(trainer.system.module.named_parameters())
    # copies: a CPU jax array may share memory with the numpy array it came from
    params = {n: jnp.array(p.detach().numpy().copy()) for n, p in named.items()}
    tx = optax.chain(optax.clip_by_global_norm(tcfg.clip_grad_norm),
                     optax.adamw(j_warmup_step_decay(tcfg.lr, tcfg.start_lr, tcfg.warm_up_steps,
                                                     tcfg.decay_step, tcfg.gamma),
                                 weight_decay=weight_decay))
    state = tx.init(params)
    update = jax.jit(tx.update)
    for k in range(3):
        grads = {n: (scale * rng.standard_normal(p.shape)).astype(np.float32) for n, p in named.items()}
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[n].copy())
        gnorm = trainer.apply_update()
        updates, state = update({n: jnp.asarray(g) for n, g in grads.items()}, state, params)
        params = jax.jit(optax.apply_updates)(params, updates)
        np.testing.assert_allclose(gnorm.item(), float(optax.global_norm(grads)), rtol=1e-6)
        assert trainer.optimizer.param_groups[0]["lr"] == trainer.schedule(k)
        for n, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), atol=1e-6, rtol=0, err_msg=n)


# -- the trainer -----------------------------------------------------------------


def test_trainer_loss_decreases_and_resumes(tmp_path, rng):
    from latent_diffusion_speech_tpu_torch.data.diffusion_dataset import DiffusionDataset

    root = _layout(tmp_path / "train", rng)
    cfg = _tiny_config(tmp_path)
    trainer = DiffusionTrainer(cfg, model_cfg=TINY_MODEL, device="cpu")
    ds = DiffusionDataset(root, waveform_sec=1.0, hop_size=2, sample_rate=100, n_spk=4)
    batch = trainer.device_put_batch(ds.batch(range(4)))
    # the same generator seed each step: a fixed (t, noise), so a fixed
    # objective that gradient steps must lower
    losses = [trainer.train_step(batch, torch.Generator().manual_seed(7))["loss"].item() for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    trainer.save()
    t2 = DiffusionTrainer(cfg, model_cfg=TINY_MODEL, device="cpu")
    assert t2.resume() and t2.step == trainer.step == 8
    for a, b in zip(t2.system.module.parameters(), trainer.system.module.parameters()):
        assert torch.equal(a, b)


def test_interrupted_run_matches_uninterrupted(tmp_path):
    ds = _DetDataset()

    def cfg(path):
        c = _tiny_config(path)
        c.diffusion.train.save_opt = True  # the optimizer moments must survive the resume
        return c

    def loader():
        return DataLoader(ds, batch_size=4, shuffle=True, seed=9)

    t_a = DiffusionTrainer(cfg(tmp_path / "a"), model_cfg=TINY_MODEL, device="cpu")
    t_a.train(loader(), max_steps=6)  # 3 batches an epoch: 2 epochs
    assert t_a.step == 6

    cfg_b = cfg(tmp_path / "b")
    t_b1 = DiffusionTrainer(cfg_b, model_cfg=TINY_MODEL, device="cpu")
    t_b1.train(loader(), max_steps=2)  # interrupted mid-epoch
    t_b2 = DiffusionTrainer(cfg_b, model_cfg=TINY_MODEL, device="cpu")
    assert t_b2.resume()
    assert (t_b2.step, t_b2._epoch, t_b2._batch_in_epoch, t_b2.opt_count) == (2, 0, 2, 2)
    t_b2.train(loader(), max_steps=6)
    assert t_b2.step == 6
    for (name, a), b in zip(t_a.system.module.named_parameters(), t_b2.system.module.parameters()):
        assert torch.equal(a, b), name


def test_checkpoint_meta_roundtrip_and_retention(tmp_path):
    params = {"w": torch.ones((2, 2))}
    for step in (10, 20, 30):
        save_checkpoint(tmp_path, step, params, keep=2, meta={"epoch": step // 10, "batch_in_epoch": step},
                        extra={"ema": params})
    assert latest_checkpoint_step(tmp_path) == 30
    assert load_checkpoint_meta(tmp_path) == {"epoch": 3, "batch_in_epoch": 30}
    assert load_checkpoint_meta(tmp_path, step=20)["epoch"] == 2
    assert json.loads((tmp_path / "model_30.meta.json").read_text())["batch_in_epoch"] == 30
    # retention deletes the sidecars with their checkpoint
    assert not any((tmp_path / f"model_10{s}").exists() for s in (".ckpt", ".meta.json", ".ema.ckpt"))
    assert (tmp_path / "model_20.ema.ckpt").exists()
    step, got, opt = load_checkpoint(tmp_path)
    assert step == 30 and opt is None and torch.equal(got["w"], params["w"])
    assert load_checkpoint_meta(tmp_path / "nope") == {} and latest_checkpoint_step(tmp_path / "nope") is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "nope")


def test_ema_tracks_saves_resumes_and_evaluates(tmp_path):
    cfg = _tiny_config(tmp_path)
    cfg.diffusion.train.ema_decay = 0.9
    trainer = DiffusionTrainer(cfg, model_cfg=TINY_MODEL, device="cpu")
    batch = trainer.device_put_batch(
        {k: np.stack([it[k] for it in _DetDataset(n=4).items]) for k in ("units", "mel", "spk_id")})
    for _ in range(3):
        trainer.train_step(batch, torch.Generator().manual_seed(3))
    live = {n: p.detach().clone() for n, p in trainer.system.module.named_parameters()}
    assert sum((live[n] - e).abs().sum().item() for n, e in trainer.ema.items()) > 0
    mel = trainer.validate(batch, torch.Generator().manual_seed(0), method="dpm-solver", speedup=5)
    assert mel.shape == batch["mel"].shape and bool(torch.isfinite(mel).all())
    for n, p in trainer.system.module.named_parameters():
        assert torch.equal(p, live[n])  # validate put the live weights back
    trainer.save()
    assert (tmp_path / "exp_diff" / "model_3.ema.ckpt").exists()
    t2 = DiffusionTrainer(cfg, model_cfg=TINY_MODEL, device="cpu")
    assert t2.resume()
    for n, e in trainer.ema.items():
        assert torch.equal(t2.ema[n], e)


def test_interval_validation_runs_during_train(tmp_path):
    """interval_val with a val loader: a save and `validate_full` (loss and
    the sampler's mel error) at each interval; `validate_full` also runs under
UniPC, the shipped config's sampler."""
    ds = _DetDataset()
    cfg = _tiny_config(tmp_path)
    cfg.diffusion.train.interval_val = 2
    cfg.common.infer.method, cfg.common.infer.speedup = "dpm-solver", 5
    logged, specs = [], []

    class Log:
        def log(self, step, metrics):
            logged.append((step, metrics))

        def log_spec_comparison(self, step, tag, pred, gt):
            specs.append((step, tag, pred.shape, gt.shape))

    trainer = DiffusionTrainer(cfg, model_cfg=TINY_MODEL, device="cpu")
    trainer.train(DataLoader(ds, batch_size=4, seed=9), val_loader=DataLoader(ds, batch_size=4, shuffle=False),
                  max_steps=2, logger=Log())
    assert trainer.step == 2 and latest_checkpoint_step(cfg.diffusion.train.expdir) == 2
    (step, metrics), = logged
    assert step == 2 and set(metrics) == {"val/loss", "val/mel_abs_err"}
    assert specs == [(2, "val/spec", (16, MEL_DIM), (16, MEL_DIM))]
    assert all(np.isfinite(v) for v in metrics.values())
    cfg.common.infer.method = "unipc"  # the shipped config's sampler
    metrics = trainer.validate_full(DataLoader(ds, batch_size=4, shuffle=False), torch.Generator().manual_seed(0))
    assert set(metrics) == {"val/loss", "val/mel_abs_err"}
    assert all(np.isfinite(v) for v in metrics.values())


def test_step_generator_is_a_function_of_seed_and_step():
    draw = [torch.randn(3, generator=step_generator(0, s, "cpu")) for s in (5, 5, 6)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], torch.randn(3, generator=step_generator(0, 5, "cpu", 1)))


def test_unported_options_raise(tmp_path):
    """A quantizer that is neither codebook type raises; accumulation and
    the learned VQ no longer do (tests/test_torch_train_options.py)."""
    with pytest.raises(TypeError, match="EuclideanCodebook or a VectorQuantize"):
        DiffusionTrainer(_tiny_config(tmp_path), model_cfg=TINY_MODEL, quantizer=object(), device="cpu")
    cfg = _tiny_config(tmp_path)
    cfg.diffusion.train.gradient_accumulation_steps = 2
    assert DiffusionTrainer(cfg, model_cfg=TINY_MODEL, device="cpu").every == 2


@pytest.mark.parametrize("axis", ["data", "model", "seq", "pipe", "expert", "dcn_data"])
def test_parallel_axes_raise_naming_item_10(tmp_path, axis):
    """Any mesh axis of `cfg.parallel` above 1 raises when the trainer is
    built (the JAX trainer builds its mesh from it; the port runs on one
    device, ROADMAP.md Queue 1, item 10), through the entry point too; the
    default config (data -1, the rest 1) still builds."""
    cfg = _tiny_config(tmp_path)
    setattr(cfg.parallel, axis, 2)
    with pytest.raises(NotImplementedError, match=f"'{axis}': 2.*item 10"):
        DiffusionTrainer(cfg, model_cfg=TINY_MODEL, device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        build(cfg, device="cpu")
    assert DiffusionTrainer(_tiny_config(tmp_path), model_cfg=TINY_MODEL, device="cpu").step == 0


def test_trainer_turns_tf32_off(tmp_path):
    """Training runs in full f32: making the trainer turns TF32 off for
    CUDA matmuls and convolutions (process-wide switches)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        DiffusionTrainer(_tiny_config(tmp_path), model_cfg=TINY_MODEL, device="cpu")
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_entry_point_builds_and_trains_with_the_kmeans_snap(tmp_path, rng):
    """`cli/train_diffusion.py::build` on a layout and a saved codebook:
    a quantized run on the CPU that saves its checkpoint."""
    units = 256  # hubert_soft's width
    root = _layout(tmp_path / "train", rng, unit_dim=units)
    codebook = rng.standard_normal((32, units)).astype(np.float32)
    np.savez(tmp_path / "cb.npz", cluster_centers_=codebook)
    cfg = _tiny_config(tmp_path)
    cfg.data.train_path = str(root)
    cfg.data.encoder = "hubert_soft"
    cfg.text2semantic.model.codebook_path = str(tmp_path / "cb.npz")
    m = cfg.diffusion.model
    m.block_out_channels, m.n_heads, m.n_hidden, m.out_dims, m.timesteps, m.k_step_max = (8, 8), 2, 8, MEL_DIM, 20, 20
    trainer, loader = build(cfg, device="cpu")
    assert isinstance(trainer.quantizer, EuclideanCodebook) and trainer.model_cfg.input_channel == units
    trainer.train(loader, max_steps=2)
    assert trainer.step == 2 and latest_checkpoint_step(cfg.diffusion.train.expdir) == 2
    snapped = trainer.quantizer(trainer.device_put_batch(next(iter(loader)))["units"])
    rows = snapped.reshape(-1, 1, units) == torch.from_numpy(codebook)[None]
    assert bool(rows.all(-1).any(-1).all())  # every frame is a codebook row


def test_debug_check_runs_in_the_training_loop(tmp_path):
    """`Config.debug` in `DiffusionTrainer.train` (as the JAX trainer wires
    `train/debug.py`): with check_interval 1 a non-finite parameter stops
    the run at the step it is found, naming it and dumping the batch."""
    from latent_diffusion_speech_tpu_torch.train.debug import NonFiniteError

    cfg = _tiny_config(tmp_path)
    cfg.debug.check_interval, cfg.debug.dump_on_nan = 1, True
    trainer = DiffusionTrainer(cfg, model_cfg=TINY_MODEL, device="cpu")
    trainer.train(DataLoader(_DetDataset(), batch_size=4, seed=9), max_steps=1)  # finite: no raise
    name, param = next(iter(trainer.system.module.named_parameters()))
    with torch.no_grad():
        param.fill_(float("nan"))
    with pytest.raises(NonFiniteError, match="sanity check failed at step 2") as err:
        trainer.train(DataLoader(_DetDataset(), batch_size=4, seed=9), max_steps=3)
    assert name in err.value.paths
    dumped = np.load(tmp_path / "exp_diff" / "nan_dump_2.npz")
    assert {"units", "mel", "__loss__"} <= set(dumped.files) and not np.isfinite(dumped["__loss__"])
