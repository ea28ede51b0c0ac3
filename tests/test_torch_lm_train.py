"""RoFormer LM training in the port against the JAX package.

Both packages get the same parameters (flax init, moved over with
`convert.roformer_from_jax`) and the same padded batches, made with numpy
from a seed; f32 on the CPU, 2 + 1 layers, C=64, H=4, V=303 (as
tests/test_torch_lm.py).  Tolerances:
* `decode_train` logits and the loss with dropout off against JAX's
  `Roformer.__call__` / `RoformerSystem.loss`: atol 2e-4, rtol 1e-3 (the LM
  parity tolerance of tests/test_torch_lm.py); every gradient against
  `jax.grad` of the JAX loss: atol 1e-5, rtol 1e-4 (tests/test_torch_train.py);
* three `LMTrainer` steps against the JAX `LMTrainer` (optax), dropout off:
  parameters within atol 1e-6;
* `top_k_accuracy` exactly JAX's;
* dropout cannot share random draws with JAX: its placement is checked by
  recording every dropout call, and its effect by the mean training loss
  over 64 generators, within 3 standard errors of JAX's over 64 keys; it is
  bitwise repeatable for one (seed, step) and off in `eval()`;
* an interrupted and resumed LM run equals an uninterrupted one bitwise
  (tests/test_resume_determinism.py's LM case is the spec);
* the trainer's checkpoint serves through `build_pipeline(lm_ckpt=)`,
  `load_native_pipeline(lm_expdir=)` and the `infer_tts --lm-model` CLI;
* stage 21 (`cli/train_lm.py::main`) trains from a corpus written by the
  port's stages 15 and 16, evaluates, logs validation audio and saves;
* `train/debug.py`: `check_step` raises and dumps on NaN.
"""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.lm.roformer import RoformerConfig as JRoformerConfig
from latent_diffusion_speech_tpu.models.lm.roformer import RoformerSystem as JRoformerSystem
from latent_diffusion_speech_tpu.models.lm.roformer import StackConfig as JStackConfig
from latent_diffusion_speech_tpu.parallel.mesh import build_mesh
from latent_diffusion_speech_tpu.train.lm_trainer import LMTrainer as JLMTrainer
from latent_diffusion_speech_tpu.train.lm_trainer import top_k_accuracy as j_top_k_accuracy
from latent_diffusion_speech_tpu_torch import config
from latent_diffusion_speech_tpu_torch.cli import infer_tts, preprocess_text, preprocess_tts, train_lm
from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline
from latent_diffusion_speech_tpu_torch.convert import roformer_from_jax
from latent_diffusion_speech_tpu_torch.data.lm_dataset import collate_text_batch
from latent_diffusion_speech_tpu_torch.data.loader import DataLoader
from latent_diffusion_speech_tpu_torch.infer.load import load_native_pipeline
from latent_diffusion_speech_tpu_torch.models.lm import roformer
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem, StackConfig
from latent_diffusion_speech_tpu_torch.models.vaegan import config as vaegan_config
from latent_diffusion_speech_tpu_torch.ops.audio_io import read_wav
from latent_diffusion_speech_tpu_torch.train import debug
from latent_diffusion_speech_tpu_torch.train.checkpoint import latest_checkpoint_step, load_checkpoint
from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer, top_k_accuracy
from latent_diffusion_speech_tpu_torch.train.optim import step_generator

ATOL, RTOL = 2e-4, 1e-3
STACK = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128)
LM = dict(semantic_kmeans_num=300, n_spk=4)
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread (the parallel test run's workers
    would otherwise spin against each other on every small op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**stack):
    jcfg = JRoformerConfig(encoder=JStackConfig(num_hidden_layers=2, **STACK, **stack),
                           decoder=JStackConfig(num_hidden_layers=1, **STACK, **stack), **LM)
    cfg = RoformerConfig(encoder=StackConfig(num_hidden_layers=2, **STACK, **stack),
                         decoder=StackConfig(num_hidden_layers=1, **STACK, **stack), **LM)
    return jcfg, cfg


@pytest.fixture(scope="module")
def lms():
    """(JAX system, port system in training mode) with the same weights and
    the default dropout (0.1)."""
    jcfg, cfg = _configs()
    jlm = JRoformerSystem(jcfg, dtype=jnp.float32, seed=0)
    state = roformer_from_jax(jax.tree_util.tree_map(np.asarray, jlm.params))
    return jlm, RoformerSystem(cfg, state_dict=state, device="cpu", training=True)


def _batch(rng, phone_lens=(10, 7, 4), sem_lens=(14, 9, 6), L=12, S=16, spk=(1, 3, 2)):
    """A collated batch (`collate_text_batch`'s keys) with both pads."""
    B = len(phone_lens)
    phone = np.full((B, L), RoformerConfig().phone_pad, np.int32)
    tone = np.zeros((B, L), np.int32)
    semantic = np.full((B, S), LM["semantic_kmeans_num"] + 2, np.int32)
    labels = np.full((B, S), -100, np.int32)
    for i, (n, m) in enumerate(zip(phone_lens, sem_lens)):
        phone[i, :n] = rng.integers(1, 60, n)
        tone[i, :n] = rng.integers(0, 5, n)
        semantic[i, :m] = rng.integers(0, 300, m)
        labels[i, :m] = semantic[i, :m]
    return {
        "phone": phone, "tone": tone, "semantic": semantic, "labels": labels,
        "encoder_attention_mask": (np.arange(L)[None] < np.array(phone_lens)[:, None]).astype(np.int32),
        "attention_mask": (np.arange(S)[None] < np.array(sem_lens)[:, None]).astype(np.int32),
        "spk_id": np.repeat(np.array(spk, np.int32)[:, None], L, axis=1),
    }


def _torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _j_loss(jlm, params, b, dropout_rng=None):
    return jlm.loss(params, b["phone"], b["tone"], b["semantic"], b["labels"], spk_id=b["spk_id"],
                    encoder_attention_mask=b["encoder_attention_mask"], attention_mask=b["attention_mask"],
                    dropout_rng=dropout_rng)


# -- the training forward, the loss and its gradients -----------------------------


def test_decode_train_logits_and_loss_match_jax(lms, rng):
    jlm, lm = lms
    b = _batch(rng)
    ref = jlm.module.apply({"params": jlm.params}, b["phone"], b["tone"], b["semantic"], b["spk_id"],
                           b["encoder_attention_mask"], b["attention_mask"])
    tb = _torch(b)
    with torch.no_grad():
        got = lm.logits(tb)
        enc = lm.module.encode(tb["phone"], tb["tone"], tb["spk_id"], tb["encoder_attention_mask"])
        split = lm.module.decode_train(tb["semantic"], enc, tb["attention_mask"], tb["encoder_attention_mask"])
        loss = lm.loss(tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert torch.equal(split, got)
    np.testing.assert_allclose(loss.item(), float(_j_loss(jlm, jlm.params, b)), atol=ATOL, rtol=RTOL)


def test_gradients_match_jax(lms, rng):
    jlm, lm = lms
    b = _batch(rng)
    ref, j_grads = jax.jit(jax.value_and_grad(lambda p: _j_loss(jlm, p, b)))(jlm.params)
    lm.module.zero_grad(set_to_none=True)
    loss = lm.loss(_torch(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    want = roformer_from_jax(jax.tree_util.tree_map(np.asarray, j_grads))
    got = {n: p.grad for n, p in lm.module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
    lm.module.zero_grad(set_to_none=True)


@pytest.mark.parametrize("k", [1, 5])
def test_top_k_accuracy_matches_jax(rng, k):
    logits = rng.standard_normal((3, 20, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 20)).astype(np.int32)
    labels[0, 12:] = -100
    labels[2, 3:] = -100
    ref = float(j_top_k_accuracy(jnp.asarray(logits), jnp.asarray(labels), k=k))
    assert top_k_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), k=k).item() == ref
    all_pad = torch.full((2, 4), -100)
    assert top_k_accuracy(torch.zeros(2, 4, 10), all_pad, k=k).item() == 0.0


# -- dropout -------------------------------------------------------------------------


def test_dropout_is_repeatable_per_step_and_off_in_eval(lms, rng):
    _, lm = lms
    tb = _torch(_batch(rng))
    with torch.no_grad():
        plain = lm.loss(tb)
        a, b = (lm.loss(tb, step_generator(0, 3, "cpu")) for _ in range(2))
        c = lm.loss(tb, step_generator(0, 4, "cpu"))
        try:
            lm.module.eval()
            off = lm.loss(tb, step_generator(0, 3, "cpu"))
        finally:
            lm.module.train()
    assert a.item() == b.item() and a.item() != c.item() and a.item() != plain.item()
    assert off.item() == plain.item()


def test_dropout_placement(lms, rng, monkeypatch):
    """Every dropout site of the JAX module, in order, at its rate: the
    embeddings (the speaker embedding added before the encoder's), each
    attention's probabilities, and after each attention / FF output
    projection; none without a generator or in eval()."""
    _, lm = lms
    m, tb = lm.module, _torch(_batch(rng))
    hidden, attn = [], []
    real_dropout, real_attention = roformer.dropout, roformer.dot_product_attention

    def record_dropout(x, rate, generator):
        hidden.append((x.detach().clone(), rate, generator is not None))
        return real_dropout(x, rate, generator)

    def record_attention(q, k, v, **kw):
        attn.append((kw["dropout_rate"], kw["generator"] is not None, kw["is_causal"]))
        return real_attention(q, k, v, **kw)

    monkeypatch.setattr(roformer, "dropout", record_dropout)
    monkeypatch.setattr(roformer, "dot_product_attention", record_attention)
    with torch.no_grad():
        m(tb["phone"], tb["tone"], tb["semantic"], tb["spk_id"], tb["encoder_attention_mask"],
          tb["attention_mask"], generator=torch.Generator().manual_seed(0))
        emb = m.enc_emb_ln(m.phone_embed(tb["phone"]) + m.tone_embed(tb["tone"])) + m.spk_embed(tb["spk_id"])
        dec = m.dec_emb_ln(m.semantic_embed(tb["semantic"]) + m.dec_type_embed(torch.zeros_like(tb["semantic"])))
    # encoder: embeddings, then (attention, FF) x 2 layers; decoder:
    # embeddings, then (self-attention, cross-attention, FF)
    assert len(hidden) == 1 + 2 * 2 + 1 + 3
    assert all(rate == 0.1 and on for _, rate, on in hidden)
    torch.testing.assert_close(hidden[0][0], emb, rtol=0, atol=0)
    torch.testing.assert_close(hidden[5][0], dec, rtol=0, atol=0)
    assert attn == [(0.1, True, False)] * 2 + [(0.1, True, True), (0.1, True, False)]
    hidden.clear()
    attn.clear()
    try:
        m.eval()
        with torch.no_grad():
            lm.loss(tb, torch.Generator().manual_seed(0))
    finally:
        m.train()
    assert len(hidden) == 9 and not any(on for *_, on in hidden) and not any(on for _, on, _ in attn)


def test_dropout_mean_loss_matches_jax(lms, rng):
    """64 draws each: the mean loss with dropout within 3 standard errors
    of JAX's (and above the loss without dropout, as dropout costs fit)."""
    jlm, lm = lms
    b = _batch(rng)
    j_loss = jax.jit(lambda key: _j_loss(jlm, jlm.params, b, dropout_rng=key))
    ref = np.array([float(j_loss(jax.random.fold_in(jax.random.PRNGKey(0), i))) for i in range(64)])
    tb = _torch(b)
    with torch.no_grad():
        got = np.array([lm.loss(tb, step_generator(1, i, "cpu")).item() for i in range(64)])
    se = np.sqrt(ref.var(ddof=1) / 64 + got.var(ddof=1) / 64)
    assert abs(got.mean() - ref.mean()) < 3 * se, (got.mean(), ref.mean(), se)
    assert got.std() > 0 and ref.std() > 0


# -- the trainer ---------------------------------------------------------------------


def _lm_config(tmp_path, clip=-1.0) -> config.Config:
    cfg = config.Config()
    cfg.common.n_spk = LM["n_spk"]
    tcfg = cfg.text2semantic.train
    tcfg.expdir = str(tmp_path / "exp_lm")
    tcfg.warm_up_steps = 2
    tcfg.clip_grad_norm = clip
    tcfg.weight_decay = 0.01
    tcfg.interval_log = tcfg.interval_val = 10_000
    return cfg


def _key_bias(name: str) -> bool:
    return name.endswith("cross_attn.key.bias")


@pytest.mark.parametrize("clip", [-1.0, 0.5])
def test_three_steps_match_the_jax_trainer(tmp_path, rng, clip):
    """Dropout off, the same initial weights and batches: the parameters
    after each of three updates (the first at start_lr, then the warm-up
    ramp; clip_grad_norm -1 is the LM default, 0.5 clips) within 1e-6.

    A cross-attention key projection's bias (no rotary) adds q.b to every
    logit of a query's row, which the softmax cancels: its gradient is zero
    but for rounding, and Adam turns that noise into steps of up to
    lr (1 - b1) / sqrt(1 - b2) = 3.16 lr (Adam's bound) in either package.
    Those biases are held instead to that bound, and the two trained models
    to the same logits (the LM parity tolerance).  A self-attention key bias
    goes through the rotary, so q_i.R_j b varies with j and its gradient is
    real: it is held to 1e-6 like every other leaf."""
    import latent_diffusion_speech_tpu.config as j_config

    jcfg, cfg = _configs(**NO_DROP)
    j_cfg = j_config.Config()
    for dst, src in ((j_cfg.common, _lm_config(tmp_path, clip).common),
                     (j_cfg.text2semantic.train, _lm_config(tmp_path, clip).text2semantic.train)):
        for k, v in vars(src).items():
            setattr(dst, k, v)
    jt = JLMTrainer(j_cfg, lm_cfg=jcfg, mesh=build_mesh(devices=jax.devices()[:1]))
    trainer = LMTrainer(_lm_config(tmp_path, clip), lm_cfg=cfg, device="cpu")
    trainer.system.module.load_state_dict(roformer_from_jax(jax.tree_util.tree_map(np.asarray, jt.system.params)))
    for step in range(3):
        b = _batch(rng)
        ref = jt.train_step(jt.device_put_batch(b))
        got = trainer.train_step(trainer.device_put_batch(b))
        np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"].item(), float(ref["grad_norm"]), rtol=1e-4)
        want = roformer_from_jax(jax.tree_util.tree_map(np.asarray, jt.system.params))
        for name, p in trainer.system.module.named_parameters():
            if _key_bias(name):
                rates = sum(trainer.schedule(k) for k in range(step + 1)) * 0.1 / 0.001 ** 0.5
                assert p.detach().abs().max().item() <= rates and want[name].abs().max().item() <= rates, name
                continue
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                       err_msg=f"{name} after update {step}")
    assert trainer.step == jt.step == 3
    b = _batch(rng)
    ref = jt.system.module.apply({"params": jt.system.params}, b["phone"], b["tone"], b["semantic"], b["spk_id"],
                                 b["encoder_attention_mask"], b["attention_mask"])
    with torch.no_grad():
        got = trainer.system.logits(_torch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


class _Items:
    """Deterministic LM items (tests/test_resume_determinism.py's)."""

    def __init__(self, n=8):
        g = np.random.default_rng(1)
        self.items = [{
            "phone": g.integers(1, 20, (10,)).astype(np.int32),
            "tone": g.integers(0, 4, (10,)).astype(np.int32),
            "semantic": g.integers(0, 16, (14,)).astype(np.int32),
            "spk_id": np.full((10,), 1, np.int32),
        } for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_interrupted_lm_run_matches_uninterrupted(tmp_path):
    """With dropout on (0.1) and the optimizer state saved: 5 steps in one
    go against 3, a save, a fresh trainer's resume (epoch 1, batch 1) and 2
    more; every parameter bitwise equal."""
    tiny = RoformerConfig(
        encoder=StackConfig(hidden_size=16, num_attention_heads=2, num_hidden_layers=1, intermediate_size=16),
        decoder=StackConfig(hidden_size=16, num_attention_heads=2, num_hidden_layers=1, intermediate_size=16),
        semantic_kmeans_num=16, n_spk=2,
    )
    collate = partial(collate_text_batch, phone_pad=tiny.phone_pad, semantic_pad=tiny.semantic_pad, pad_multiple=8)

    def cfg(path):
        c = _lm_config(path)
        c.common.n_spk = 2
        c.text2semantic.train.save_opt = True
        return c

    def loader():
        return DataLoader(_Items(), batch_size=4, collate=collate, shuffle=True, seed=2)

    t_a = LMTrainer(cfg(tmp_path / "a"), lm_cfg=tiny, device="cpu")
    t_a.train(loader(), max_steps=5)
    cfg_b = cfg(tmp_path / "b")
    LMTrainer(cfg_b, lm_cfg=tiny, device="cpu").train(loader(), max_steps=3)
    t_b = LMTrainer(cfg_b, lm_cfg=tiny, device="cpu")
    assert t_b.resume()
    assert (t_b.step, t_b._epoch, t_b._batch_in_epoch, t_b.opt_count) == (3, 1, 1, 3)
    t_b.train(loader(), max_steps=5)
    assert t_a.step == t_b.step == 5
    for (name, a), b in zip(t_a.system.module.named_parameters(), t_b.system.module.parameters()):
        assert torch.equal(a, b), name


def test_what_is_not_ported_raises(tmp_path):
    """Every axis is served (tests/test_torch_parallel.py,
    tests/test_torch_expert_parallel.py, tests/test_torch_ring_attention.py,
    tests/test_torch_pipeline_parallel.py), so a seq, pipe, expert or data
    axis of 2 on a world of one process raises JAX's ValueError (the axes
    do not fit)."""
    for field in ("seq", "pipe"):
        cfg = _lm_config(tmp_path)
        setattr(cfg.parallel, field, 2)
        with pytest.raises(ValueError, match=rf"mesh: 1 devices not divisible by .*{field}\(2\)"):
            LMTrainer(cfg, device="cpu")
    cfg = _lm_config(tmp_path)
    cfg.parallel.expert = 2
    with pytest.raises(ValueError, match=r"mesh: 1 devices not divisible by .*expert\(2\)"):
        LMTrainer(cfg, device="cpu")
    cfg = _lm_config(tmp_path)
    cfg.parallel.data = 2
    with pytest.raises(ValueError, match=r"mesh: data\(2\).* != devices\(1\)"):
        LMTrainer(cfg, device="cpu")


def test_nan_guard_and_debug_check_raise(tmp_path, rng):
    """A NaN loss raises on a guarded step (before the update); a NaN in a
    parameter the loss does not reach is found by `Config.debug`'s check,
    which dumps the batch."""
    _, cfg_lm = _configs(**NO_DROP)
    cfg = _lm_config(tmp_path)
    trainer = LMTrainer(cfg, lm_cfg=cfg_lm, device="cpu")
    b = trainer.device_put_batch(_batch(rng))
    with torch.no_grad():
        trainer.system.module.head_bias[0] = float("nan")
    before = trainer.system.module.enc_0.ff_in.weight.detach().clone()
    with pytest.raises(RuntimeError, match="NaN/Inf LM loss at step 0"):
        trainer.train_step(b)
    assert torch.equal(trainer.system.module.enc_0.ff_in.weight, before)

    cfg.debug.check_interval, cfg.debug.dump_on_nan = 1, True
    trainer = LMTrainer(cfg, lm_cfg=cfg_lm, device="cpu")
    with torch.no_grad():
        trainer.system.module.spk_embed.weight[0] = float("nan")  # speaker 0 is never drawn
    with pytest.raises(debug.NonFiniteError, match="spk_embed.weight") as err:
        trainer.train(DataLoader(_ListData([_batch(rng)]), batch_size=1, collate=lambda items: items[0]),
                      max_steps=1)
    assert err.value.paths == ["spk_embed.weight"]
    dumped = np.load(tmp_path / "exp_lm" / "nan_dump_1.npz")
    assert set(dumped.files) >= {"phone", "labels", "__loss__", "__step__"} and int(dumped["__step__"]) == 1


class _ListData:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_deterministic_algorithms_is_scoped():
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import deterministic_algorithms

    assert not torch.are_deterministic_algorithms_enabled()
    with deterministic_algorithms():
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.is_deterministic_algorithms_warn_only_enabled()


def test_check_step_and_install():
    params = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, float("inf")])}, "n": torch.arange(3)}
    assert debug.tree_nonfinite_paths(params) == ["b.c"]
    with pytest.raises(debug.NonFiniteError, match="b.c"):
        debug.assert_tree_finite(params)
    dcfg = config.DebugConfig(check_interval=2)
    debug.check_step(dcfg, 3, params, float("nan"))  # off cadence: no check
    debug.check_step(None, 2, params, float("nan"))
    with pytest.raises(debug.NonFiniteError, match="loss=non-finite"):
        debug.check_step(dcfg, 2, {"a": torch.ones(2)}, torch.tensor(float("nan")))
    big = {"w": torch.full((4,), 3e38)}  # finite values whose squares overflow f32
    assert debug.tree_nonfinite_paths(big) == []
    assert not torch.is_anomaly_enabled()
    with debug.install(config.DebugConfig(debug_nans=True)):
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()


# -- serving the checkpoint, and stage 21 ---------------------------------------------

VAEGAN = dict(sampling_rate=8000, inter_channels=6, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
              upsample_rates=(4, 2), upsample_initial_channel=16, upsample_kernel_sizes=(8, 4))
EN_LABELS = {
    "spk_a": ["Hello world, this is a test.", "The cat sat on the mat.", "We will meet again soon."],
    "spk_b": ["Good morning to everyone here.", "It is a fine day today.", "Bring the book back home."],
}


@pytest.fixture
def tiny_vocoder(monkeypatch):
    port_vaegan = vaegan_config.VAEGANConfig
    monkeypatch.setattr(vaegan_config, "VAEGANConfig", lambda: port_vaegan(**VAEGAN))


def _tiny_serve_config(tmp_path) -> config.Config:
    """The shipped config at tiny widths (tests/test_torch_serve_entry.py's
    shrink) with the test LM's stack; nothing exists at the codebook and
    vocoder paths."""
    cfg = config.load_config(str(__import__("pathlib").Path(__file__).resolve().parent.parent / "configs"
                                 / "config.yaml"))
    cfg.common.n_spk = LM["n_spk"]
    cfg.common.vocoder.ckpt = str(tmp_path / "no-vocoder")
    m = cfg.diffusion.model
    m.block_out_channels, m.n_heads, m.n_hidden, m.n_layers, m.out_dims = (8, 8), 2, 8, 1, 6
    cfg.diffusion.train.expdir = str(tmp_path / "exp_diff")
    lm = cfg.text2semantic.model
    lm.codebook_path = str(tmp_path / "no-codebook.npz")
    lm.semantic_kmeans_num = LM["semantic_kmeans_num"]
    for stack in (lm.encoder, lm.decoder):
        stack.hidden_size, stack.num_attention_heads, stack.intermediate_size = 64, 4, 128
    lm.encoder.num_hidden_layers = 2
    tcfg = cfg.text2semantic.train
    tcfg.expdir, tcfg.batch_size, tcfg.warm_up_steps = str(tmp_path / "exp_lm"), 4, 2
    tcfg.interval_log = tcfg.interval_val = 2
    return cfg


def test_trained_checkpoint_serves(tmp_path, rng, tiny_vocoder):
    """`build_pipeline(lm_ckpt=)` (the experiment dir and one
    model_<step>.ckpt), `load_native_pipeline(lm_expdir=)` and the
    `infer_tts --lm-model` CLI serve the trainer's weights: the same state,
    and greedy tokens equal to the trainer's own generate."""
    cfg = _tiny_serve_config(tmp_path)
    trainer = LMTrainer(cfg, device="cpu")
    for _ in range(2):
        trainer.train_step(trainer.device_put_batch(_batch(rng)))
    trainer.save()
    trainer.system.module.eval()
    phones, tones = _batch(rng)["phone"][:1, :7], _batch(rng)["tone"][:1, :7]
    want = trainer.system.generate(phones, tones, spk_id=2, max_length=24, do_sample=False)
    expdir = tmp_path / "exp_lm"
    for pipe in (build_pipeline(cfg, lm_ckpt=str(expdir), dtype=torch.float32, device="cpu"),
                 build_pipeline(cfg, lm_ckpt=str(expdir / "model_2.ckpt"), dtype=torch.float32, device="cpu"),
                 load_native_pipeline(cfg, lm_expdir=str(expdir), dtype=torch.float32, device="cpu")):
        state = pipe.lm.module.state_dict()
        for name, t in trainer.system.module.state_dict().items():
            assert torch.equal(state[name], t), name
        assert not pipe.lm.module.training
        got = pipe.lm.generate(phones, tones, spk_id=2, max_length=24, do_sample=False)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    bf16 = build_pipeline(cfg, lm_ckpt=str(expdir), device="cpu")
    assert bf16.lm.module.enc_0.ff_in.weight.dtype == torch.bfloat16
    assert bf16.lm.module.phone_embed.weight.dtype == torch.float32  # embeddings stay f32, as seeded

    cfg_path = tmp_path / "config.yaml"
    config.save_config(cfg, cfg_path)
    out = tmp_path / "cli.wav"
    infer_tts.main(["-c", str(cfg_path), "-l", "EN", "-i", "Hello world.", "-o", str(out), "--lm-model",
                    str(expdir), "--speedup", "100", "--device", "cpu"])
    wav, sr = read_wav(out)
    assert sr == VAEGAN["sampling_rate"] and wav.size > 0


def _write_corpus(root, rng, labels=EN_LABELS):
    """Per-utterance `.txt` labels beside empty `.wav` files, and seeded
    token ids in stage 19's format (`semantic_token/<spk>/<name>.wav.npy`,
    int32) with ~7 tokens a word character."""
    for spk, texts in labels.items():
        (root / "audio" / spk).mkdir(parents=True, exist_ok=True)
        (root / "semantic_token" / spk).mkdir(parents=True, exist_ok=True)
        for n, text in enumerate(texts):
            (root / "audio" / spk / f"{n}.wav").write_bytes(b"")
            (root / "audio" / spk / f"{n}.txt").write_text(text + "\n", encoding="utf-8")
            ids = rng.integers(0, LM["semantic_kmeans_num"], 2 * len(text)).astype(np.int32)
            np.save(root / "semantic_token" / spk / f"{n}.wav.npy", ids)


def test_stage_21_trains_from_the_ports_own_stages(tmp_path, rng, tiny_vocoder):
    """Stages 15 and 16 write `utt/`, stage 21's `main` trains 2 steps on
    it, evaluates on the valid set, writes validation audio through the
    frozen pipeline and saves a checkpoint that the LM loads back."""
    cfg = _tiny_serve_config(tmp_path)
    cfg.data.train_path, cfg.data.valid_path = str(tmp_path / "train"), str(tmp_path / "val")
    _write_corpus(tmp_path / "train", rng)
    _write_corpus(tmp_path / "val", rng, {"spk_a": EN_LABELS["spk_a"] + ["One more line for the set."]})
    cfg_path = tmp_path / "config.yaml"
    config.save_config(cfg, cfg_path)
    preprocess_text.main(["-c", str(cfg_path)])
    preprocess_tts.main(["-c", str(cfg_path), "--language", "EN"])
    for name, _ in preprocess_tts.process_tts(cfg.data.valid_path, language="EN"):
        assert name.endswith(".wav")
    assert len(list((tmp_path / "train" / "utt").rglob("*.wav.npy"))) == 6

    train_lm.main(["-c", str(cfg_path), "--max-steps", "2", "--device", "cpu"])
    expdir = tmp_path / "exp_lm"
    assert latest_checkpoint_step(expdir) == 2
    records = [json.loads(line) for line in (expdir / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert {"train/loss", "train/grad_norm", "train/steps_per_sec", "train/samples_per_sec"} <= set(records[0])
    val = [r for r in records if "val/loss" in r]
    assert len(val) == 1 and 0.0 <= val[0]["val/top5_acc"] <= 1.0 and np.isfinite(val[0]["val/loss"])
    wav, sr = read_wav(expdir / "logs" / "audio" / "val_audio_0_2.wav")
    assert sr == VAEGAN["sampling_rate"] and wav.size > 0
    assert (expdir / "config.yaml").exists()
    _, params, opt_state = load_checkpoint(expdir)
    assert opt_state is not None and opt_state["count"] == 2
    lm = RoformerSystem(LMTrainer(cfg, device="cpu").lm_cfg, state_dict=params, device="cpu")
    assert not lm.module.training
