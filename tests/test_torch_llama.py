"""The Llama LM and its MoE feed-forward in the port against the JAX package.

Both packages get the same parameters (the JAX module's flax init, moved
over with `convert.llama_from_jax`) and the same inputs, made with numpy
from a seed; f32 on the CPU, 2 layers, C=32, H=4, K=32 (V=143).
Tolerances:
* logits (forward and `decode_step`): atol 3e-4, rtol 1e-3, the Llama
  parity tolerance of tests/test_lm.py (against HF); the loss with the
  MoE auxiliary loss rtol 1e-5;
* `MoEMLP` against JAX's: rtol 1e-4, atol 1e-5 (tests/test_moe.py's
  `TestRouting`), every routing case of that class;
* greedy `generate`: JAX's tokens and lengths exactly;
* `collate_llama_batch`: JAX's arrays bit for bit;
* the `type: llama` trainer: two updates against the JAX `LMTrainer`
  within atol 1e-6 (tests/test_torch_lm_train.py's bound), `evaluate`
  within the logits tolerance, an interrupted run bitwise equal to an
  uninterrupted one;
* `llama_params_from_torch` on an HF `LlamaForCausalLM` built from a
  config: JAX's tree bit for bit, the port's logits against HF's within the
  logits tolerance; `verify_import --kind llama` JAX's report.
"""

import argparse
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.cli import verify_import as j_verify
from latent_diffusion_speech_tpu.data.lm_dataset import collate_llama_batch as j_collate_llama_batch
from latent_diffusion_speech_tpu.infer.tts import TTSPipeline as JTTSPipeline
from latent_diffusion_speech_tpu.models.lm.import_hf import llama_params_from_torch as j_llama_params_from_torch
from latent_diffusion_speech_tpu.models.lm.llama import LlamaConfig as JLlamaConfig
from latent_diffusion_speech_tpu.models.lm.llama import LlamaSystem as JLlamaSystem
from latent_diffusion_speech_tpu.ops.moe import MoEMLP as JMoEMLP
from latent_diffusion_speech_tpu.parallel.mesh import build_mesh
from latent_diffusion_speech_tpu.train.lm_trainer import LMTrainer as JLMTrainer
from latent_diffusion_speech_tpu.train.lm_trainer import top_k_accuracy as j_top_k_accuracy
from latent_diffusion_speech_tpu_torch import config
from latent_diffusion_speech_tpu_torch.cli import verify_import
from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline
from latent_diffusion_speech_tpu_torch.convert import llama_from_jax
from latent_diffusion_speech_tpu_torch.data.lm_dataset import collate_llama_batch
from latent_diffusion_speech_tpu_torch.data.loader import DataLoader
from latent_diffusion_speech_tpu_torch.models.lm.import_hf import llama_params_from_torch, llama_state_from_torch
from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaConfig, LlamaSystem, rotary_half
from latent_diffusion_speech_tpu_torch.models.lm.registry import get_language_model, llama_config_from
from latent_diffusion_speech_tpu_torch.models.vaegan import config as vaegan_config
from latent_diffusion_speech_tpu_torch.ops.moe import MoEMLP
from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer
from latent_diffusion_speech_tpu_torch.utils.flops import StepFlops

ATOL, RTOL = 3e-4, 1e-3
MOE_RTOL, MOE_ATOL = 1e-4, 1e-5
GEOM = dict(hidden_size=32, num_attention_heads=4, num_hidden_layers=2, intermediate_size=48, semantic_kmeans_num=32)
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0)  # some tokens overflow at cf 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=["dense", "moe"])
def lms(request):
    """(JAX system, port system) with the same weights."""
    kw = dict(GEOM, **(MOE if request.param == "moe" else {}))
    jlm = JLlamaSystem(JLlamaConfig(**kw), seed=0)
    return jlm, LlamaSystem(LlamaConfig(**kw), state_dict=llama_from_jax(_np_tree(jlm.params)), device="cpu")


def _ids(rng, lm, B=3, T=13):
    ids = rng.integers(0, lm.cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 9:] = 0
    mask[2, 5:] = 0
    return ids, mask


def test_forward_and_loss_match_jax(lms, rng):
    """Logits with a padding mask, and the loss (CE + the MoE auxiliary
    loss's weighted mean over layers) with -100 labels on the padding."""
    jlm, lm = lms
    ids, mask = _ids(rng, lm)
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    ref = jax.jit(jlm.module.apply)({"params": jlm.params}, jnp.asarray(ids), jnp.asarray(mask))
    batch = {"input_ids": torch.from_numpy(ids).long(), "attention_mask": torch.from_numpy(mask),
             "labels": torch.from_numpy(labels).long()}
    with torch.no_grad():
        logits, aux = lm.module(batch["input_ids"], batch["attention_mask"])
        loss = lm.loss(batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert len(aux) == (GEOM["num_hidden_layers"] if lm.cfg.moe_experts else 0)
    want = jax.jit(jlm.loss)(jlm.params, jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(mask))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    if lm.cfg.moe_experts:  # the auxiliary term is in it
        assert abs(loss.item() - lm._ce(logits, batch["labels"]).item()) > 1e-4


def test_decode_step_matches_jax(lms, rng):
    """The cache path: a 6-token prompt prefilled in one pass (the port)
    against JAX's token-at-a-time `decode_step`, then 4 decode steps."""
    jlm, lm = lms
    B, P, N = 2, 6, 4
    ids = rng.integers(0, lm.cfg.vocab_size, (B, P + N)).astype(np.int32)
    jcache = jlm.module.apply({"params": jlm.params}, B, P + N, method=jlm.module.init_cache)
    j_step = jax.jit(partial(jlm.module.apply, method=jlm.module.decode_step))
    caches = lm.module.init_cache(B, P + N)
    with torch.no_grad():
        lm.module.prefill(torch.from_numpy(ids[:, :P]).long(), caches)
        for pos in range(P + N):
            ref, jcache = j_step({"params": jlm.params}, jnp.asarray(ids[:, pos]), pos, jcache)
            if pos < P:
                continue
            got, caches = lm.module.decode_step(torch.from_numpy(ids[:, pos]).long(), pos, caches)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL, err_msg=f"pos {pos}")
    for c, jc in zip(caches, jcache):
        np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]), atol=1e-5)


def test_greedy_generate_matches_jax(lms, rng):
    jlm, lm = lms
    phone = rng.integers(1, 40, (1, 7)).astype(np.int32)
    jt, jl = jlm.generate(jnp.asarray(phone), np.zeros_like(phone), max_length=16, do_sample=False,
                          rng=jax.random.PRNGKey(0))
    tokens, lengths = lm.generate(phone, np.zeros_like(phone), max_length=16, do_sample=False)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))
    assert tokens.dtype == lengths.dtype == torch.int32
    # text tokens are banned: every generated id is in the semantic space
    assert (tokens[0, : int(lengths[0])] >= 0).all()
    # sampling draws from the same support: in range, repeatable per generator
    a = lm.generate(phone, max_length=8, generator=torch.Generator().manual_seed(3))
    b = lm.generate(phone, max_length=8, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and (a[0] >= 0).all() and (a[0] <= lm.cfg.semantic_kmeans_num + 2).all()


def test_build_input_ids_and_rotary_match_jax(lms, rng):
    jlm, lm = lms
    phone = rng.integers(1, 40, (2, 5)).astype(np.int32)
    sem = rng.integers(0, 32, (2, 7)).astype(np.int32)
    got = lm.build_input_ids(torch.from_numpy(phone), torch.from_numpy(sem))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlm.build_input_ids(jnp.asarray(phone), jnp.asarray(sem))))
    from latent_diffusion_speech_tpu.models.lm.llama import rotary_half as j_rotary_half

    x = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(rotary_half(torch.from_numpy(x), torch.arange(3, 8), 10000.0).numpy(),
                               np.asarray(j_rotary_half(jnp.asarray(x), jnp.arange(3, 8), 10000.0)), atol=1e-6)


def test_rmsnorm_dtypes_follow_jax():
    """bf16 in, f32 out (the f32 scale): the bf16 LM keeps JAX's residual dtypes."""
    lm = LlamaSystem(LlamaConfig(**GEOM), dtype=torch.bfloat16, device="cpu")
    x = torch.randn(2, 3, 32).to(torch.bfloat16)
    assert lm.module.block_0.input_ln(x).dtype == torch.float32
    assert lm.module.block_0.q_proj.weight.dtype == torch.bfloat16
    assert lm.module.embed_tokens.weight.dtype == torch.float32
    moe = LlamaSystem(LlamaConfig(**GEOM, **MOE), dtype=torch.bfloat16, device="cpu").module.block_0.moe
    assert moe.w_gate.dtype == torch.bfloat16 and moe.gate.dtype == torch.float32
    tokens, lengths = LlamaSystem(LlamaConfig(**GEOM, **MOE), dtype=torch.bfloat16, device="cpu").generate(
        np.array([[3, 4, 5]]), max_length=6, do_sample=False)
    assert tokens.shape == (1, 6)


def test_seeded_weights_draw_flax_initialisers():
    """LeCun-normal products, N(0, 1/C) embeddings, unit norms, N(0, 0.02) MoE banks."""
    m = LlamaSystem(LlamaConfig(hidden_size=256, num_attention_heads=4, num_hidden_layers=1, intermediate_size=512,
                                semantic_kmeans_num=64, **MOE), device="cpu").module
    assert abs(m.block_0.q_proj.weight.std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert abs(m.embed_tokens.weight.std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert torch.equal(m.final_ln.weight, torch.ones(256))
    for name in ("gate", "w_gate", "w_up", "w_down"):
        assert abs(getattr(m.block_0.moe, name).std().item() - 0.02) < 0.002, name
    # the codebook warm start writes the reference's rows len(symbols) - 1 ...
    # (JAX's raises: it writes into the read-only numpy view of a jax array,
    # ROADMAP R13)
    cb = np.random.default_rng(0).standard_normal((32, 32)).astype(np.float32)
    lm = LlamaSystem(LlamaConfig(**GEOM), device="cpu", codebook=cb)
    lo = lm.cfg.token_shift - 1
    np.testing.assert_array_equal(lm.module.embed_tokens.weight[lo: lo + 32].detach().numpy(), cb)
    seeded = LlamaSystem(LlamaConfig(**GEOM), device="cpu").module.embed_tokens.weight.detach()
    rest = torch.ones(seeded.shape[0], dtype=torch.bool)
    rest[lo: lo + 32] = False
    assert torch.equal(lm.module.embed_tokens.weight.detach()[rest], seeded[rest])
    with pytest.raises(ValueError, match="read-only"):
        JLlamaSystem(JLlamaConfig(**GEOM), codebook=cb)


def test_loss_pp_raises_naming_parallelism():
    with pytest.raises(NotImplementedError, match="item 10"):
        LlamaSystem(LlamaConfig(**GEOM), device="cpu").loss_pp()


# -- MoEMLP routing (tests/test_moe.py::TestRouting) ------------------------------------


def _moe_pair(x, E, F, k, cf, seed=0):
    """The JAX module and the port's with the same parameters, drawn with
    numpy at a scale that makes the outputs O(1) (a flax init of the module
    costs seconds of eager tracing here)."""
    C = x.shape[-1]
    g = np.random.default_rng(seed)
    params = {name: (0.5 * g.standard_normal(shape)).astype(np.float32)
              for name, shape in (("gate", (C, E)), ("w_gate", (E, C, F)), ("w_up", (E, C, F)), ("w_down", (E, F, C)))}
    jm = JMoEMLP(num_experts=E, intermediate_size=F, top_k=k, capacity_factor=cf)
    m = MoEMLP(C, E, F, top_k=k, capacity_factor=cf)
    m.load_state_dict({n: torch.from_numpy(np.array(v)) for n, v in params.items()})
    return jm, params, m


def test_moe_single_expert_equals_dense_swiglu(rng):
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    jm, p, m = _moe_pair(x, 1, 32, 1, 2.0)
    with torch.no_grad():
        y, _ = m(torch.from_numpy(x))
    ref = (jax.nn.silu(x @ p["w_gate"][0]) * (x @ p["w_up"][0])) @ p["w_down"][0]
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax.jit(jm.apply)({"params": p}, jnp.asarray(x))[0]),
                               rtol=MOE_RTOL, atol=MOE_ATOL)


def test_moe_topk_matches_jax_and_the_brute_force_mixture(rng):
    """capacity_factor = E: capacity k S, no token can overflow."""
    E, k = 4, 2
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    jm, p, m = _moe_pair(x, E, 16, k, float(E))
    with torch.no_grad():
        y, aux = m(torch.from_numpy(x))
    jy, jaux = jax.jit(jm.apply)({"params": p}, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=MOE_RTOL, atol=MOE_ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    xf = x.reshape(-1, 8)
    probs = np.asarray(jax.nn.softmax(xf @ np.asarray(p["gate"]), axis=-1))
    ref = np.zeros_like(xf)
    for s in range(xf.shape[0]):
        top = np.argsort(-probs[s])[:k]
        gates = probs[s][top] / probs[s][top].sum()
        for g, e in zip(gates, top):
            h = jax.nn.silu(xf[s] @ p["w_gate"][e]) * (xf[s] @ p["w_up"][e])
            ref[s] += g * np.asarray(h @ p["w_down"][e])
    np.testing.assert_allclose(y.numpy().reshape(-1, 8), ref, rtol=MOE_RTOL, atol=MOE_ATOL)
    assert m.drop_fraction.item() == 0.0


def test_moe_overflow_tokens_are_dropped_as_in_jax(rng):
    """Identical tokens all route to one expert; with capacity 1 exactly
    one is served (the first: slot-major priority) and the rest carry zero."""
    S = 8
    x = np.tile(rng.standard_normal((1, 1, 8)).astype(np.float32), (1, S, 1))
    jm, p, m = _moe_pair(x, 4, 16, 1, 0.5)
    with torch.no_grad():
        y, _ = m(torch.from_numpy(x))
    assert m.capacity(S) == 1
    nonzero = np.abs(y.numpy()[0]).sum(-1) > 0
    assert nonzero.tolist() == [True] + [False] * (S - 1)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax.jit(jm.apply)({"params": p}, jnp.asarray(x))[0]),
                               rtol=MOE_RTOL, atol=MOE_ATOL)
    assert m.drop_fraction.item() == pytest.approx(7 / 8)


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25])
def test_moe_partial_drops_match_jax(rng, cf):
    """Top-2 over random tokens at capacities that drop some second (and
    first) choices: the same tokens dropped as in JAX's one-hot dispatch."""
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    jm, p, m = _moe_pair(x, 4, 16, 2, cf, seed=1)
    with torch.no_grad():
        y, aux = m(torch.from_numpy(x))
    jy, jaux = jax.jit(jm.apply)({"params": p}, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=MOE_RTOL, atol=MOE_ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    if cf < 1.0:
        assert m.drop_fraction.item() > 0


def test_moe_aux_loss_matches_jax_and_is_one_when_balanced(rng):
    x = rng.standard_normal((2, 8, 8)).astype(np.float32)
    jm, p, m = _moe_pair(x, 4, 16, 2, 1.25)
    (_, jaux), muts = jax.jit(partial(jm.apply, mutable=["moe_losses"]))({"params": p}, jnp.asarray(x))
    _, aux = m(torch.from_numpy(x))
    np.testing.assert_allclose(aux.item(), float(muts["moe_losses"]["aux"][0]), rtol=1e-6)
    assert aux.requires_grad  # the router learns from it
    with torch.no_grad():
        m.gate.zero_()  # a uniform router: every probability 1/E
        _, aux = m(torch.ones(1, 8, 8))
    np.testing.assert_allclose(aux.item(), 1.0, rtol=1e-6)


def test_moe_ties_go_to_the_lower_expert():
    """Equal router probabilities pick the lowest expert ids, as
    jax.lax.top_k does: a zero router sends every token to experts 0 and 1."""
    from latent_diffusion_speech_tpu_torch.ops.moe import top_k_lowest_index

    vals, idx = top_k_lowest_index(torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]]), 2)
    assert idx.tolist() == [[0, 1], [1, 3]] and torch.equal(vals, torch.tensor([[0.25, 0.25], [0.4, 0.4]]))
    x = np.ones((1, 4, 8), np.float32)
    jm, p, m = _moe_pair(x, 4, 16, 2, 4.0)
    p = dict(p, gate=np.zeros_like(p["gate"]))
    with torch.no_grad():
        m.gate.zero_()
        y, _ = m(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jax.jit(jm.apply)({"params": p}, jnp.asarray(x))[0]),
                               rtol=MOE_RTOL, atol=MOE_ATOL)


def test_moe_builds_no_one_hot_dispatch_tensor():
    """At S = 4096 tokens, E = 8, top-2, cf 1.25 (capacity 1280), JAX's
    (k S, E, capacity) f32 dispatch and combine tensors take 336 MB each;
    here no operation of a forward or its backward makes a tensor of even
    a twentieth of that (the largest are (E, capacity + 1, F) and (k S, C))."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else [out]:
                if isinstance(t, torch.Tensor):
                    self.bytes = max(self.bytes, t.numel() * t.element_size())
            return out

    m = MoEMLP(64, 8, 128, top_k=2, capacity_factor=1.25)
    m.init_flax(torch.Generator().manual_seed(0))
    x = torch.randn(4, 1024, 64, requires_grad=True)
    one_hot_bytes = 2 * 4096 * 8 * m.capacity(4096) * 4
    assert one_hot_bytes > 300e6
    with Largest() as largest:
        y, aux = m(x)
        (y.square().sum() + aux).backward()
    assert y.shape == x.shape and 0 < largest.bytes < one_hot_bytes / 20, largest.bytes
    assert largest.bytes >= 8 * (m.capacity(4096) + 1) * 128 * 4  # the expert activations were seen


def test_moe_gradients_match_jax(rng):
    """Gradients of a loss through the routed experts (router included)."""
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    jm, p, m = _moe_pair(x, 4, 16, 2, 1.0)

    def j_loss(params, xs):
        y, aux = jm.apply({"params": params}, xs)
        return jnp.sum(y ** 2) + 0.1 * aux

    jg, jgx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y, aux = m(xt)
    (torch.sum(y ** 2) + 0.1 * aux).backward()
    for name, param in m.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), np.asarray(jg[name]), rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-6)


# -- collate, trainer, checkpoints ------------------------------------------------------


def _items(rng, K=32, n=4):
    out = []
    for _ in range(n):
        phones = rng.integers(1, 40, size=rng.integers(3, 8)).astype(np.int32)
        sem = rng.integers(0, K, size=rng.integers(4, 10)).astype(np.int32)
        out.append({"phone": phones, "tone": np.zeros_like(phones), "spk_id": np.ones_like(phones),
                    "semantic": np.concatenate([[K], sem, [K + 1]]).astype(np.int32)})
    return out


@pytest.mark.parametrize("pad_multiple,max_len", [(8, None), (32, None), (8, 40)])
def test_collate_llama_batch_equals_jax(rng, pad_multiple, max_len):
    cfg = LlamaConfig(**GEOM)
    kw = dict(token_shift=cfg.token_shift, phone_bos=cfg.phone_bos, phone_eos=cfg.phone_eos,
              pad_id=cfg.pad_token_id, pad_multiple=pad_multiple, max_len=max_len)
    items = _items(rng)
    got, want = collate_llama_batch(items, **kw), j_collate_llama_batch(items, **kw)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert got["input_ids"].shape[1] % pad_multiple == 0 or max_len


def _llama_config(tmp_path, moe: bool) -> config.Config:
    cfg = config.Config()
    m = cfg.text2semantic.model
    m.type, m.semantic_kmeans_num = "llama", GEOM["semantic_kmeans_num"]
    m.decoder.hidden_size, m.decoder.num_attention_heads = GEOM["hidden_size"], GEOM["num_attention_heads"]
    m.decoder.num_hidden_layers, m.decoder.intermediate_size = GEOM["num_hidden_layers"], GEOM["intermediate_size"]
    if moe:
        m.moe_experts, m.moe_top_k, m.moe_capacity_factor = 4, 2, 1.0
    tcfg = cfg.text2semantic.train
    tcfg.expdir = str(tmp_path / "exp_lm")
    tcfg.warm_up_steps, tcfg.weight_decay, tcfg.batch_size = 2, 0.01, 4
    tcfg.interval_log = tcfg.interval_val = 10_000
    return cfg


def _collate(cfg, items, pad_multiple=8):
    return collate_llama_batch(items, token_shift=cfg.token_shift, phone_bos=cfg.phone_bos,
                               phone_eos=cfg.phone_eos, pad_id=cfg.pad_token_id, pad_multiple=pad_multiple)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_two_steps_and_evaluate_match_the_jax_trainer(tmp_path, rng, moe):
    """The same initial weights and batches: loss, gradient norm and every
    parameter after each of two AdamW updates (start_lr, then the warm-up
    ramp) within 1e-6; then `evaluate` (the MoE auxiliary loss in
    val/loss) and top-5 accuracy."""
    import latent_diffusion_speech_tpu.config as j_config

    cfg = _llama_config(tmp_path, moe)
    j_cfg = j_config.Config()
    for dst, src in ((j_cfg.text2semantic.model, cfg.text2semantic.model),
                     (j_cfg.text2semantic.train, cfg.text2semantic.train)):
        for key, v in vars(src).items():
            if not dataclasses.is_dataclass(v):
                setattr(dst, key, v)
    for key, v in vars(cfg.text2semantic.model.decoder).items():
        setattr(j_cfg.text2semantic.model.decoder, key, v)
    jt = JLMTrainer(j_cfg, mesh=build_mesh(devices=jax.devices()[:1]))
    trainer = LMTrainer(cfg, device="cpu")
    assert trainer.lm_cfg == llama_config_from(cfg) and isinstance(trainer.system, LlamaSystem)
    trainer.system.module.load_state_dict(llama_from_jax(_np_tree(jt.system.params)))
    params = dict(trainer.system.module.named_parameters())
    tiny = {name: torch.zeros_like(p, dtype=torch.bool) for name, p in params.items()}
    for step in range(2):
        b = _collate(trainer.lm_cfg, _items(rng))
        ref = jt.train_step(jt.device_put_batch(b))
        got = trainer.train_step(trainer.device_put_batch(b))
        np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"].item(), float(ref["grad_norm"]), rtol=1e-4)
        want = llama_from_jax(_np_tree(jt.system.params))
        # Adam moves an element whose gradient is at rounding level (|g| <
        # 1e-6) by up to lr (1 - b1) / sqrt(1 - b2) = 3.16 lr a step in either
        # package, whatever its sign: those elements are held to that bound
        bound = sum(trainer.schedule(k) for k in range(step + 1)) * 0.1 / 0.001 ** 0.5
        for name, p in params.items():
            tiny[name] |= p.grad.abs() < 1e-6
            d = (p.detach() - want[name]).abs()
            assert torch.where(tiny[name], 0.0, d).max().item() <= 1e-6, f"{name} after update {step}"
            assert torch.where(tiny[name], d, 0.0).max().item() <= bound, f"{name} after update {step}"
    # JAX's `evaluate` for a Llama, jitted (it runs the loss eagerly: ~10 s
    # of op-by-op dispatch with experts)
    b = _collate(trainer.lm_cfg, _items(rng))
    got, jb = trainer.evaluate(trainer.device_put_batch(b)), jt.device_put_batch(b)
    logits = jt._eval_logits(jt.system.params, jb)
    loss = jax.jit(jt.system.loss)(jt.system.params, jb["input_ids"], jb["labels"], jb["attention_mask"])
    np.testing.assert_allclose(got["val/loss"], float(loss), rtol=1e-5)
    acc = j_top_k_accuracy(logits[:, :-1], jb["labels"][:, 1:], k=5)
    assert got["val/top5_acc"] == pytest.approx(float(acc), abs=1e-6)


class _Items:
    def __init__(self, n=8):
        self.items = _items(np.random.default_rng(1), n=n)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_llama_training_descends_and_resumes_bitwise(tmp_path, moe):
    """5 steps in one go against 3, a save, a fresh trainer's resume and 2
    more: every parameter bitwise equal; the loss falls over 12 steps on one
    repeated batch."""
    def cfg(path):
        c = _llama_config(path, moe)
        c.text2semantic.train.save_opt = True
        return c

    lm_cfg = llama_config_from(cfg(tmp_path))
    collate = partial(collate_llama_batch, token_shift=lm_cfg.token_shift, phone_bos=lm_cfg.phone_bos,
                      phone_eos=lm_cfg.phone_eos, pad_id=lm_cfg.pad_token_id, pad_multiple=8)

    def loader():
        return DataLoader(_Items(), batch_size=4, collate=collate, shuffle=True, seed=2)

    t_a = LMTrainer(cfg(tmp_path / "a"), device="cpu")
    t_a.train(loader(), max_steps=5)
    LMTrainer(cfg(tmp_path / "b"), device="cpu").train(loader(), max_steps=3)
    t_b = LMTrainer(cfg(tmp_path / "b"), device="cpu")
    assert t_b.resume() and (t_b.step, t_b._epoch, t_b._batch_in_epoch) == (3, 1, 1)
    t_b.train(loader(), max_steps=5)
    for (name, a), b in zip(t_a.system.module.named_parameters(), t_b.system.module.parameters()):
        assert torch.equal(a, b), name

    t = LMTrainer(cfg(tmp_path / "c"), device="cpu")
    b = t.device_put_batch(collate(_Items(4).items))
    losses = [t.train_step(b)["loss"].item() for _ in range(12)]
    assert losses[-1] < losses[0] - 0.2 and losses[-1] == min(losses), losses


def test_step_flops_count_the_llama_and_moe_products():
    """`StepFlops` sees every product of a Llama MoE step: the forward's
    projections, attention, router, expert and head products by formula,
    and the backward twice the forward."""
    cfg = LlamaConfig(**GEOM, moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
    lm = LlamaSystem(cfg, device="cpu")
    B, T = 2, 16
    ids = torch.randint(0, cfg.vocab_size, (B, T))
    batch = {"input_ids": ids, "labels": ids}
    C, F, V, E, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.moe_experts, cfg.num_hidden_layers
    S, cap = B * T, lm.module.block_0.moe.capacity(B * T)
    per_layer = 2 * S * C * C * 4 + 2 * 2 * B * T * T * C + 2 * S * C * E + 2 * E * (cap + 1) * C * F * 3
    forward = L * per_layer + 2 * S * C * V
    with StepFlops() as counter, torch.no_grad():
        lm.loss(batch)
    assert counter.total == forward
    with StepFlops() as counter:
        lm.loss(batch).backward()
    assert counter.total == 3 * forward


# -- weights across -------------------------------------------------------------------


def _hf_llama(cfg, seed=0):
    import os

    # transformers' TensorFlow side is not used (its import costs ~5 s here)
    os.environ.setdefault("USE_TF", "0")
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import LlamaForCausalLM

    torch.manual_seed(seed)
    hf_cfg = HFLlamaConfig(hidden_size=cfg.hidden_size, num_attention_heads=cfg.num_attention_heads,
                           num_hidden_layers=cfg.num_hidden_layers, intermediate_size=cfg.intermediate_size,
                           vocab_size=cfg.vocab_size, num_key_value_heads=cfg.num_attention_heads,
                           rms_norm_eps=cfg.rms_norm_eps)
    return LlamaForCausalLM(hf_cfg).eval()


def test_llama_importer_matches_jax_and_hf(rng):
    cfg = LlamaConfig(**GEOM)
    ref = _hf_llama(cfg)
    state = ref.state_dict()
    mine, theirs = llama_params_from_torch(state, cfg), _np_tree(j_llama_params_from_torch(state, JLlamaConfig(**GEOM)))
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(theirs)):
        assert np.array_equal(a, b)
    lm = LlamaSystem(cfg, state_dict=llama_state_from_torch({f"llama.{k}": v for k, v in state.items()}, cfg),
                     device="cpu")
    ids = rng.integers(0, cfg.vocab_size, (2, 9))
    with torch.no_grad():
        want = ref(torch.from_numpy(ids)).logits.numpy()
        got = lm.module(torch.from_numpy(ids))[0].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_verify_import_llama_reports_jax_numbers(tmp_path):
    cfg = LlamaConfig(hidden_size=32, num_attention_heads=2, num_hidden_layers=3, intermediate_size=40,
                      semantic_kmeans_num=24)
    state = {f"llama.{k}": v for k, v in _hf_llama(cfg, seed=1).state_dict().items()}
    torch.save({"model": state}, tmp_path / "model_100.pt")
    args = dict(path=str(tmp_path / "model_100.pt"), kind="auto", heads=2, golden=None, tol=1e-3, json=True)
    got = verify_import.verify(argparse.Namespace(**args, save_golden=str(tmp_path / "g.npz"), device="cpu"))
    want = j_verify.verify(argparse.Namespace(**args, save_golden=None))
    assert got["kind"] == want["kind"] == "llama"
    for key in ("geometry", "torch_keys_read", "torch_keys_unused", "torch_elements", "imported_elements",
                "output_shape", "output_finite"):
        assert got[key] == want[key], key
    for key in ("output_mean", "output_std"):
        assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-6), key
    # a golden the port wrote is a golden for the JAX CLI
    assert j_verify.verify(argparse.Namespace(**dict(args, golden=str(tmp_path / "g.npz")),
                                              save_golden=None))["golden_match"]
    assert verify_import.main([args["path"], "--heads", "2", "--device", "cpu", "--json"]) == 0


# -- serving ----------------------------------------------------------------------------

VAEGAN = dict(sampling_rate=8000, inter_channels=6, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
              upsample_rates=(4, 2), upsample_initial_channel=16, upsample_kernel_sizes=(8, 4))


def _serve_config(tmp_path) -> config.Config:
    cfg = config.load_config(str(__import__("pathlib").Path(__file__).resolve().parent.parent / "configs"
                                 / "config.yaml"))
    cfg.common.vocoder.ckpt = str(tmp_path / "no-vocoder")
    m = cfg.diffusion.model
    m.block_out_channels, m.n_heads, m.n_hidden, m.n_layers, m.out_dims = (8, 8), 2, 8, 1, 6
    lm = cfg.text2semantic.model
    lm.type, lm.codebook_path, lm.semantic_kmeans_num = "llama", str(tmp_path / "no-codebook.npz"), 32
    lm.decoder.hidden_size, lm.decoder.num_attention_heads, lm.decoder.intermediate_size = 32, 4, 48
    lm.decoder.num_hidden_layers = 2
    cfg.text2semantic.train.expdir = str(tmp_path / "exp_lm")
    return cfg


def test_llama_checkpoint_serves_and_tts_batch_raises_as_jax(tmp_path, monkeypatch):
    """A `type: llama` config: the registry builds a LlamaSystem; a trainer
    checkpoint serves through `build_pipeline(lm_ckpt=)` (the trainer's
    weights, its greedy tokens) and `tts_from_phones` / `tts` give audio;
    `tts_batch` raises TypeError, as JAX's does (its Llama generate takes no
    attention_mask: ROADMAP R11)."""
    port_vaegan = vaegan_config.VAEGANConfig
    monkeypatch.setattr(vaegan_config, "VAEGANConfig", lambda: port_vaegan(**VAEGAN))
    cfg = _serve_config(tmp_path)
    assert isinstance(get_language_model(cfg, device="cpu"), LlamaSystem)
    trainer = LMTrainer(cfg, device="cpu")
    trainer.train_step(trainer.device_put_batch(_collate(trainer.lm_cfg, _items(np.random.default_rng(0)))))
    trainer.save()
    pipe = build_pipeline(cfg, lm_ckpt=cfg.text2semantic.train.expdir, dtype=torch.float32, device="cpu")
    assert isinstance(pipe.lm, LlamaSystem)
    for name, t in trainer.system.module.state_dict().items():
        assert torch.equal(pipe.lm.module.state_dict()[name], t), name
    phones = np.array([5, 9, 11, 3, 20], np.int32)
    want = trainer.system.generate(phones[None], max_length=12, do_sample=False)
    got = pipe.lm.generate(phones[None], np.zeros((1, 5), np.int32), spk_id=2, max_length=12, do_sample=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    wav, sr = pipe.tts_from_phones(phones, np.zeros_like(phones), spk_id=1, max_length=24, infer_speedup=100)
    assert sr == VAEGAN["sampling_rate"] and np.isfinite(wav).all()
    wav, _ = pipe.tts("Hello world.", language="EN", max_length=24, infer_speedup=100)
    assert np.isfinite(wav).all()
    with pytest.raises(TypeError, match="R11"):
        pipe.tts_batch(["Hello world."], language="EN", max_length=8)
    with pytest.raises(TypeError, match="R11"):
        pipe.tts_long_text("Hello world. Good morning.", language="EN", max_length=8)
    # the JAX pipeline raises there too: at the RoFormer's phone_pad, before
    # its generate would refuse attention_mask
    jpipe = JTTSPipeline.__new__(JTTSPipeline)
    jpipe.lm, jpipe.codebook, jpipe.lm_impl = JLlamaSystem(JLlamaConfig(**GEOM)), np.zeros((32, 4), np.float32), None
    jpipe.text_to_phones = lambda text, language="ZH": (np.array([5, 9], np.int32), np.zeros(2, np.int32))
    with pytest.raises(AttributeError, match="phone_pad"):
        jpipe.tts_batch(["Hello world."], language="EN", max_length=8)
    with pytest.raises(TypeError, match="attention_mask"):
        jpipe.lm.generate(np.array([[5, 9]]), np.zeros((1, 2)), attention_mask=np.ones((1, 2)))


def test_stage_21_builds_and_trains_the_llama(tmp_path, monkeypatch):
    """`cli/train_lm.py` with `type: llama`: the loader wraps the semantic
    ids with the unshifted BOS/EOS and collates one stream, JAX's batches
    bit for bit; `main` trains two steps and saves a checkpoint the
    registry's LlamaSystem loads."""
    from latent_diffusion_speech_tpu.data.lm_dataset import TextDataset as JTextDataset
    from latent_diffusion_speech_tpu_torch.cli import train_lm
    from latent_diffusion_speech_tpu_torch.train.checkpoint import latest_checkpoint_step, load_checkpoint

    port_vaegan = vaegan_config.VAEGANConfig
    monkeypatch.setattr(vaegan_config, "VAEGANConfig", lambda: port_vaegan(**VAEGAN))
    # the metrics logger's TensorBoard sink is not under test (its import
    # loads TensorFlow here, ~10 s): the JSONL sink alone
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
    g = np.random.default_rng(4)
    for split in ("train", "val"):
        for i in range(6):
            name = f"spk{i % 2}/{i}.wav.npy"
            phones = g.integers(1, 100, g.integers(4, 12)).astype(np.int32)
            for sub, arr in (("utt", np.array((phones, np.zeros_like(phones), np.zeros_like(phones), []),
                                              dtype=object)), ("semantic_token", g.integers(0, 32, 20).astype(np.int32))):
                (tmp_path / split / sub / f"spk{i % 2}").mkdir(parents=True, exist_ok=True)
                np.save(tmp_path / split / sub / name, arr, allow_pickle=True)
    cfg = _serve_config(tmp_path)
    cfg.data.train_path, cfg.data.valid_path = str(tmp_path / "train"), str(tmp_path / "val")
    tcfg = cfg.text2semantic.train
    tcfg.batch_size, tcfg.interval_log, tcfg.interval_val, tcfg.length_sorted = 3, 1, 10_000, False
    trainer, loader, val_loader, logger, pipe = train_lm.build(cfg, device="cpu")
    try:
        assert trainer.lm_type == "llama" and isinstance(pipe.lm, LlamaSystem)
        K = cfg.text2semantic.model.semantic_kmeans_num
        jds = JTextDataset(cfg.data.train_path, semantic_bos=K, semantic_eos=K + 1, n_spk=cfg.common.n_spk)
        assert loader.dataset.paths == jds.paths
        items = [loader.dataset[i] for i in range(3)]
        got = loader.collate(items)
        want = j_collate_llama_batch([jds[i] for i in range(3)], token_shift=trainer.lm_cfg.token_shift,
                                     phone_bos=trainer.lm_cfg.phone_bos, phone_eos=trainer.lm_cfg.phone_eos,
                                     pad_id=trainer.lm_cfg.pad_token_id)
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    finally:
        for x in (loader, val_loader, logger):
            x.close()
    config.save_config(cfg, tmp_path / "config.yaml")
    train_lm.main(["-c", str(tmp_path / "config.yaml"), "--max-steps", "2", "--device", "cpu"])
    assert latest_checkpoint_step(tcfg.expdir) == 2
    _, params, _ = load_checkpoint(tcfg.expdir)
    assert isinstance(get_language_model(cfg, device="cpu", state_dict=params), LlamaSystem)
