"""The port's migration path against the JAX package's, on the CPU: the
reference's checkpoints read by `models/lm/import_hf.py`,
`models/diffusion/import_torch.py`, `infer/load.py::load_reference_pipeline`
and `cli/verify_import.py`.

Reference-layout state dicts are built here (the reference repository is
not in the tree): the RoFormer from HF parts (`tests/test_lm.py`), the
Unit2Mel by `chip_smoke.py::reference_unit2mel_state` from a JAX tree, held
first to be the exact inverse of the JAX importer.

* importers: the port's `roformer_state_from_torch`,
  `unit2mel_state_from_torch` and `block_params_from_torch` equal the JAX
  importers followed by `convert.py`, bit for bit; `chip_smoke.py`'s two
  inverses give back the JAX tree they started from, bit for bit, and the
  RoFormer's has the HF modules' keys;
* forwards: RoFormer logits (atol 3e-4, rtol 1e-3) and Unit2Mel
  condition + denoise (atol 5e-5, rtol 1e-4), the JAX package's own parity
  tolerances (tests/test_verify_import.py, tests/test_torch_codec.py);
* `load_reference_pipeline` over a whole artifact set in both packages: the
  same geometry, the same tokens (top_k=1) and, from one x_init, the same
  waveform (atol 5e-5, rtol 1e-4); the latest step of a directory, a
  missing codebook; `weight_quant: int8` loads;
* `verify_import`: each forward kind against a golden the JAX CLI wrote
  (tol 1e-4), with the same report; `detect_kind` over the fingerprints;
  the kinds whose modules wait raise naming their ROADMAP item; `main`'s
  exit codes.
"""

import argparse
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from chip_smoke import reference_roformer_state, reference_unit2mel_state
from latent_diffusion_speech_tpu.cli import verify_import as j_verify
from latent_diffusion_speech_tpu.infer.load import load_reference_pipeline as j_load_reference_pipeline
from latent_diffusion_speech_tpu.models.diffusion import Unit2Mel as JUnit2Mel
from latent_diffusion_speech_tpu.models.diffusion import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.diffusion import import_torch as j_import_torch
from latent_diffusion_speech_tpu.models.lm import import_hf as j_import_hf
from latent_diffusion_speech_tpu.models.lm.roformer import Roformer as JRoformer
from latent_diffusion_speech_tpu.models.lm.roformer import RoformerConfig as JRoformerConfig
from latent_diffusion_speech_tpu.models.lm.roformer import StackConfig as JStackConfig
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.cli import verify_import
from latent_diffusion_speech_tpu_torch.infer.load import load_reference_pipeline
from latent_diffusion_speech_tpu_torch.models.diffusion import import_torch
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2Mel, Unit2MelConfig
from latent_diffusion_speech_tpu_torch.models.lm import import_hf
from latent_diffusion_speech_tpu_torch.models.lm.roformer import Roformer, RoformerConfig, StackConfig
from tests.test_lm import _build_hf_roformer
from tests.test_vaegan import TINY as VA_TINY
from tests.test_vaegan import TorchEncoder, TorchGenerator

U2M = dict(input_channel=16, n_spk=4, use_pitch_aug=False, out_dims=8, n_hidden=12,
           block_out_channels=(16, 24, 32, 32), n_layers=1, n_heads=4)
STACK = dict(hidden_size=16, num_attention_heads=2, num_hidden_layers=1, intermediate_size=16)
LM = dict(semantic_kmeans_num=32, n_spk=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread (the parallel run's workers would
    otherwise spin against each other on every small op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trained_like(shapes, seed):
    """Numpy draws on a flax tree's shapes (`jax.eval_shape` of its init: no
    compile), at a trained scale: kernels N(0, 1 / fan_in), norm scales
    1 + N(0, 0.1), embeddings N(0, 1), biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        noise = rng.standard_normal(shape)
        if name == "kernel":
            noise = noise * (1.0 / np.prod(shape[:-1])) ** 0.5
        elif name == "scale":
            noise = 1.0 + 0.1 * noise
        elif name != "embedding":
            noise = 0.1 * noise
        return noise.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _u2m_shapes(jcfg):
    units, spk, scalar = jnp.zeros((1, 8, jcfg.input_channel)), jnp.ones((1, 8), jnp.int32), jnp.zeros((1, 8))
    return jax.eval_shape(lambda: JUnit2Mel(jcfg).init(
        jax.random.PRNGKey(0), units, volume=None if jcfg.is_tts else scalar, spk_id=spk,
        aug_shift=scalar if jcfg.use_pitch_aug else None))["params"]


def _lm_shapes(jcfg):
    a = jnp.ones((1, 4), jnp.int32)
    return jax.eval_shape(lambda: JRoformer(jcfg).init(jax.random.PRNGKey(0), a, a, a, spk_id=a))["params"]


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and isinstance(want, dict), path
    assert sorted(got) == sorted(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            assert np.asarray(got[k]).dtype == np.float32, f"{path}/{k}"
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{path}/{k}")


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _lm_cfgs(**over):
    lm = {**LM, **over}
    return (JRoformerConfig(encoder=JStackConfig(**STACK), decoder=JStackConfig(**STACK), **lm),
            RoformerConfig(encoder=StackConfig(**STACK), decoder=StackConfig(**STACK), **lm))


# -- the RoFormer importer ---------------------------------------------------------


@pytest.fixture(scope="module")
def hf_roformer():
    torch.manual_seed(0)
    return _build_hf_roformer(_lm_cfgs()[0])


@pytest.mark.parametrize("layout", ["hf", "decoder_bias_only", "no_speaker"])
def test_roformer_importer_matches_jax(hf_roformer, layout):
    """The head bias falls back to `cls.predictions.decoder.bias`;
    `spk_emb` is optional; the tied decoder weight is never read."""
    jcfg, cfg = _lm_cfgs()
    state = dict(hf_roformer.state_dict())
    if layout == "decoder_bias_only":
        state["semantic_decoder.cls.predictions.decoder.bias"] = torch.randn(jcfg.semantic_vocab_size)
        del state["semantic_decoder.cls.predictions.bias"]
    if layout == "no_speaker":
        del state["spk_emb.weight"]
    tree = j_import_hf.roformer_params_from_torch(state, jcfg)
    _assert_trees_equal(import_hf.roformer_params_from_torch(state, cfg), tree)
    _assert_states_equal(import_hf.roformer_state_from_torch(state, cfg), convert.roformer_from_jax(_np(tree)))


def test_roformer_inverse_gives_back_the_jax_tree(hf_roformer):
    jcfg, cfg = _lm_cfgs()
    tree = _trained_like(_lm_shapes(jcfg), 1)
    ref = reference_roformer_state(convert.roformer_from_jax(tree), cfg)
    hf = hf_roformer.state_dict()
    assert sorted(ref) == sorted(hf)
    assert all(ref[k].shape == hf[k].shape for k in hf)
    np.testing.assert_allclose(ref["text_encoder.encoder.embed_positions.weight"].numpy(),
                               hf["text_encoder.encoder.embed_positions.weight"].numpy(), atol=1e-6)
    _assert_trees_equal(j_import_hf.roformer_params_from_torch(ref, jcfg), tree)


def test_roformer_logits_match_jax(hf_roformer, rng):
    jcfg, cfg = _lm_cfgs()
    state = hf_roformer.state_dict()
    module = Roformer(cfg)
    module.load_state_dict(import_hf.roformer_state_from_torch(state, cfg))
    module.eval()
    B, L, S = 1, 12, 16  # verify_import's shapes (JAX's eager ops compile once a shape)
    phone, tone = rng.integers(0, 40, (B, L)), rng.integers(0, 6, (B, L))
    semantic, spk = rng.integers(0, 32, (B, S)), rng.integers(0, 4, (B, L))
    want = JRoformer(jcfg).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, j_import_hf.roformer_params_from_torch(state, jcfg))},
        jnp.asarray(phone), jnp.asarray(tone), jnp.asarray(semantic), jnp.asarray(spk))
    with torch.no_grad():
        got = module(*(torch.from_numpy(a) for a in (phone, tone, semantic, spk)))
        hf = hf_roformer(*(torch.from_numpy(a) for a in (phone, tone, semantic, spk)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), hf.numpy(), atol=3e-4, rtol=1e-3)


def test_llama_importer_waits():
    """The Llama importer (it raised until the Llama was ported): a
    reference-layout state dict (`chip_smoke.reference_llama_state`, with
    and without the `llama.` prefix) gives JAX's tree bit for bit, and
    `llama_state_from_torch` gives back the port state it was made from.
    tests/test_torch_llama.py holds it to HF's LlamaForCausalLM."""
    from chip_smoke import reference_llama_state
    from latent_diffusion_speech_tpu.models.lm.llama import LlamaConfig as JLlamaConfig
    from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaConfig, LlamaSystem

    geom = dict(hidden_size=16, num_attention_heads=2, num_hidden_layers=2, intermediate_size=24,
                semantic_kmeans_num=20)
    cfg = LlamaConfig(**geom)
    state = LlamaSystem(cfg, device="cpu", seed=3).module.state_dict()
    for prefix in ("llama.", ""):
        ref = reference_llama_state(state, prefix)
        mine, theirs = import_hf.llama_params_from_torch(ref, cfg), j_import_hf.llama_params_from_torch(
            ref, JLlamaConfig(**geom))
        assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(theirs)
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(jax.tree_util.tree_leaves(mine),
                                                                    jax.tree_util.tree_leaves(theirs)))
        back = import_hf.llama_state_from_torch(ref, cfg)
        assert back.keys() == state.keys() and all(torch.equal(back[k], state[k]) for k in state)


# -- the Unit2Mel importer ---------------------------------------------------------


def _u2m_tree(seed, **over):
    jcfg = JUnit2MelConfig(**{**U2M, **over})
    return jcfg, Unit2MelConfig(**{**U2M, **over}), _trained_like(_u2m_shapes(jcfg), seed)


@pytest.mark.parametrize("over", [{}, {"use_pitch_aug": True, "is_tts": False}], ids=["tts", "volume_and_pitch"])
def test_unit2mel_inverse_and_importer_match_jax(over):
    """The inverse gives back the JAX tree; buffers of the reference's
    GaussianDiffusion under `decoder.` are not read; the port's importer
    equals the JAX importer through `convert.unit2mel_from_jax`."""
    jcfg, cfg, tree = _u2m_tree(2, **over)
    ref = reference_unit2mel_state(convert.unit2mel_from_jax(tree))
    ref["decoder.betas"] = torch.linspace(1e-4, 0.02, 1000)
    ref["decoder.alphas_cumprod"] = torch.rand(1000)
    assert any(".proj_in.weight" in k and v.dim() == 3 for k, v in ref.items())
    j_tree = j_import_torch.unit2mel_params_from_torch(ref, jcfg)
    _assert_trees_equal(j_tree, tree)
    _assert_trees_equal(import_torch.unit2mel_params_from_torch(ref, cfg), j_tree)
    _assert_states_equal(import_torch.unit2mel_state_from_torch(ref, cfg), convert.unit2mel_from_jax(j_tree))


def test_unit2mel_condition_and_denoise_match_jax(rng):
    jcfg, cfg, tree = _u2m_tree(3)
    ref = reference_unit2mel_state(convert.unit2mel_from_jax(tree))
    module = Unit2Mel(cfg)
    module.load_state_dict(import_torch.unit2mel_state_from_torch(ref, cfg))
    module.eval()
    jmodule = JUnit2Mel(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, j_import_torch.unit2mel_params_from_torch(ref, jcfg))
    units = rng.standard_normal((1, 64, 16)).astype(np.float32)
    x_t = rng.standard_normal((1, 64, 8)).astype(np.float32)
    spk = np.full((1, 1), 3, np.int32)
    cond = jmodule.apply({"params": params}, jnp.asarray(units), None, jnp.asarray(spk), None,
                         method=jmodule.condition)
    want = jmodule.apply({"params": params}, jnp.concatenate([jnp.asarray(x_t), cond], -1),
                         jnp.asarray([10], jnp.int32), method=jmodule.denoise)
    with torch.no_grad():
        got_cond = module.condition(torch.from_numpy(units), None, torch.from_numpy(spk).long(), None)
        got = module.denoise(torch.cat([torch.from_numpy(x_t), got_cond], -1), torch.tensor([10]))
    np.testing.assert_allclose(got_cond.numpy(), np.asarray(cond), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-4)
    assert np.abs(np.asarray(want)).max() > 0.1  # a forward at a trained-like scale


def _reference_layout(tree, prefix=""):
    """A flax block-zoo tree as a reference (torch) state dict: list indices
    split out of the module names, torch layouts, and every 2-D
    `proj_in` / `proj_out` kernel as a k=1 convolution (the layout the
    template resolves)."""
    import re

    out = {}
    for key, val in tree.items():
        name = re.sub(r"_(\d+)$", r".\1", key)
        path = f"{prefix}.{name}" if prefix else name
        if isinstance(val, dict):
            out.update(_reference_layout(val, path))
            continue
        mod, leaf = path.rsplit(".", 1)
        if key == "kernel":
            if val.ndim == 3:
                w = np.transpose(val, (2, 1, 0))
            else:
                w = val.T[:, :, None] if mod.endswith(("proj_in", "proj_out")) else val.T
            out[f"{mod}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        elif key == "scale":
            out[f"{mod}.weight"] = torch.from_numpy(val)
        else:
            out[path] = torch.from_numpy(val)
    return out


def test_block_importer_matches_jax_on_the_general_unet():
    """The general denoiser's `UNet1DCondition` (the ported block types):
    a reference-layout state dict through both `block_params_from_torch`
    with the template, then `convert.unit2mel_from_jax` into the port's
    module."""
    jcfg, cfg, tree = _u2m_tree(4, denoiser="general")
    template = tree["unet"]
    state = _reference_layout(template)
    assert any(k.endswith("proj_in.weight") and v.dim() == 3 for k, v in state.items())
    j_tree = j_import_torch.block_params_from_torch(state, template=template)
    got = import_torch.block_params_from_torch(state, template=template)
    _assert_trees_equal(got, j_tree)
    _assert_trees_equal(got, template)
    module = Unit2Mel(cfg)
    module.load_state_dict(convert.unit2mel_from_jax({**tree, "unet": got}))


# -- load_reference_pipeline ---------------------------------------------------------


def _config(root):
    """A reference config.yaml (tests/test_reference_migration.py's)."""
    return {
        "data": {"encoder": "whisper_large_v3", "acoustic_scale": 1.0, "block_size": 512,
                 "sampling_rate": 44100, "encoder_sample_rate": 16000, "encoder_hop_size": 320,
                 "units_forced_mode": "nearest", "extensions": ["wav"],
                 "train_path": "data/train", "valid_path": "data/val", "duration": 1},
        "common": {"n_spk": 4, "vocoder": {"type": "hifi-vaegan", "ckpt": str(root / "vaegan"),
                   "only_mean": True, "clamp": 10.0}, "infer": {"method": "ddim", "speedup": 100}},
        "diffusion": {"model": {"block_out_channels": [16, 24, 32, 32], "n_layers": 1,
                                "n_heads": 4, "n_hidden": 12, "use_pitch_aug": False, "n_chans": 32},
                      "train": {"expdir": str(root / "diffusion")}},
        "text2semantic": {"model": {"mode": "phone", "semantic_kmeans_num": 32,
                                    "codebook_path": str(root / "semantic_codebook.pt"),
                                    "type": "roformer",
                                    "decoder": dict(STACK), "encoder": dict(STACK)},
                          "train": {"expdir": str(root / "lm")}},
    }


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, hf_roformer):
    """The reference's artifact set: diffusion `model_77.pt` (and an older
    `model_7.pt`) with `config.yaml`, LM `model_55.pt`,
    `semantic_codebook.pt` (the sklearn dict) and a HiFi-VAEGAN pair."""
    root = tmp_path_factory.mktemp("ref_exp")
    rng = np.random.default_rng(5)
    torch.manual_seed(5)
    h = {k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(VA_TINY).items()}
    h["resblock_dilation_sizes"] = [list(d) for d in VA_TINY.resblock_dilation_sizes]
    (root / "vaegan").mkdir()
    for name, module in (("encoder", TorchEncoder(VA_TINY)), ("decoder", TorchGenerator(VA_TINY))):
        with torch.no_grad():
            for n, p in module.named_parameters():
                if n.endswith("weight_g"):  # trained-like weight norm: g != ||v||
                    p.mul_(torch.from_numpy(rng.uniform(0.2, 3.0, p.shape).astype(np.float32)))
        torch.save({"model": module.state_dict(), "config": h}, root / "vaegan" / f"{name}.pth")

    jcfg = JUnit2MelConfig(**{**U2M, "input_channel": 1280, "out_dims": VA_TINY.inter_channels})
    (root / "diffusion").mkdir()
    shapes = _u2m_shapes(jcfg)
    for step, seed in ((7, 6), (77, 7)):
        tree = _trained_like(shapes, seed)
        state = reference_unit2mel_state(convert.unit2mel_from_jax(tree))
        torch.save({"global_step": step, "model": state}, root / "diffusion" / f"model_{step}.pt")
    (root / "diffusion" / "config.yaml").write_text(yaml.safe_dump(_config(root)))

    (root / "lm").mkdir()
    torch.save({"global_step": 55, "model": hf_roformer.state_dict()}, root / "lm" / "model_55.pt")
    cb = rng.standard_normal((32, 1280)).astype(np.float32)
    torch.save({"n_features_in_": 1280, "_n_threads": 4, "cluster_centers_": torch.from_numpy(cb),
                "n_clusters": 32}, root / "semantic_codebook.pt")
    return root


def _load_both(root, **kw):
    args = dict(lm_ckpt=root / "lm", codebook_path=root / "semantic_codebook.pt", vocoder_path=root / "vaegan")
    args.update(kw)
    return (j_load_reference_pipeline(root / "diffusion", dtype=jnp.float32, **args),
            load_reference_pipeline(root / "diffusion", dtype=torch.float32, device="cpu", **args))


@pytest.fixture(scope="module")
def pipes(artifacts):
    return _load_both(artifacts)


def test_reference_pipeline_geometry_matches_jax(pipes, artifacts):
    jpipe, pipe = pipes
    assert pipe.device.type == "cpu"
    assert dataclasses.asdict(pipe.diffusion.cfg) == dataclasses.asdict(jpipe.diffusion.cfg)
    assert pipe.diffusion.cfg.out_dims == pipe.vocoder.dimension // 2 == VA_TINY.inter_channels
    assert dataclasses.asdict(pipe.lm.cfg) == dataclasses.asdict(jpipe.lm.cfg)
    assert dataclasses.asdict(pipe.vocoder.cfg) == dataclasses.asdict(jpipe.vocoder.vocoder.cfg)
    np.testing.assert_array_equal(pipe.codebook.codebook.numpy(), np.asarray(jpipe.codebook.codebook))
    # the latest step of the directory: model_77's weights
    latest = torch.load(artifacts / "diffusion" / "model_77.pt", weights_only=False)["model"]
    _assert_states_equal(pipe.diffusion.module.state_dict(),
                         import_torch.unit2mel_state_from_torch(latest, pipe.diffusion.cfg))


def test_reference_pipeline_tts_from_phones_matches_jax(pipes, monkeypatch):
    """Greedy tokens (top_k=1) equal; DDIM (4 steps) + vocoder from one
    x_init within atol 5e-5, rtol 1e-4; the same rate."""
    jpipe, pipe = pipes
    x0 = np.random.default_rng(8).standard_normal((1, 64, VA_TINY.inter_channels)).astype(np.float32)
    jd, d = jpipe.diffusion.diffusion, pipe.diffusion.diffusion
    for diffusion, x_init in ((jd, jnp.asarray(x0)), (d, torch.from_numpy(x0))):
        sample = functools.partial(type(diffusion).sample, diffusion)
        monkeypatch.setattr(diffusion, "sample", lambda *a, _s=sample, _x=x_init, **kw: _s(*a, **{**kw, "x_init": _x}))
    tokens = {}
    for name, p in (("jax", jpipe), ("port", pipe)):
        generate = p.generate_semantic

        def spy(*a, _name=name, _generate=generate, **kw):
            tokens[_name] = _generate(*a, **kw)
            return tokens[_name]

        monkeypatch.setattr(p, "generate_semantic", spy)
    phones, tones = np.array([3, 4, 5, 6], np.int32), np.zeros(4, np.int32)
    kw = dict(spk_id=1, method="ddim", infer_speedup=250, max_length=6, top_k=1)
    want, want_sr = jpipe.tts_from_phones(phones, tones, **kw)
    got, sr = pipe.tts_from_phones(phones, tones, **kw)
    assert len(tokens["port"]) > 0
    np.testing.assert_array_equal(tokens["port"], tokens["jax"])
    assert sr == want_sr == VA_TINY.sampling_rate
    assert got.shape == np.asarray(want).shape == (len(tokens["port"]) * VA_TINY.hop_size,)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5, rtol=1e-4)
    assert np.abs(got).max() > 1e-3


def test_reference_pipeline_picks_the_step_and_tolerates_no_codebook(artifacts):
    pipe = load_reference_pipeline(artifacts / "diffusion" / "model_7.pt", vocoder_path=artifacts / "vaegan",
                                   codebook_path=artifacts / "no-codebook.pt", dtype=torch.float32, device="cpu")
    assert pipe.codebook is None and pipe.lm is None
    older = torch.load(artifacts / "diffusion" / "model_7.pt", weights_only=False)["model"]
    _assert_states_equal(pipe.diffusion.module.state_dict(),
                         import_torch.unit2mel_state_from_torch(older, pipe.diffusion.cfg))
    assert pipe.diffusion.module.unit_embed.weight.dtype == torch.float32


def test_reference_pipeline_skips_embeddings_the_config_turns_off(artifacts, tmp_path):
    """A reference key the module has no place for (here `volume_embed`,
    with TTS's `is_tts`) is not loaded, as flax ignores it in JAX."""
    ckpt = torch.load(artifacts / "diffusion" / "model_77.pt", weights_only=False)
    ckpt["model"]["volume_embed.weight"] = torch.randn(12, 1)
    ckpt["model"]["volume_embed.bias"] = torch.randn(12)
    torch.save(ckpt, tmp_path / "model_78.pt")
    (tmp_path / "config.yaml").write_text((artifacts / "diffusion" / "config.yaml").read_text())
    jpipe = j_load_reference_pipeline(tmp_path, vocoder_path=artifacts / "vaegan", dtype=jnp.float32)
    pipe = load_reference_pipeline(tmp_path, vocoder_path=artifacts / "vaegan", dtype=torch.float32, device="cpu")
    assert "volume_embed" in jpipe.diffusion.params and not hasattr(pipe.diffusion.module, "volume_embed")
    want = convert.unit2mel_from_jax(_np({k: v for k, v in jpipe.diffusion.params.items() if k != "volume_embed"}))
    _assert_states_equal(pipe.diffusion.module.state_dict(), want)


def test_reference_pipeline_weight_quant_raises(artifacts, tmp_path):
    """A reference config with `weight_quant: int8` loads (it raised until
    int8 serving weights were ported): the diffusion model serves on int8
    UNet weights, as JAX's loader builds it."""
    cfg = _config(artifacts)
    cfg["common"]["infer"]["weight_quant"] = "int8"
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "model_77.pt").symlink_to(artifacts / "diffusion" / "model_77.pt")
    pipe = load_reference_pipeline(tmp_path, device="cpu")
    assert pipe.diffusion.weight_quant == "int8"


def test_reference_pipeline_defaults_to_bf16(artifacts):
    pipe = load_reference_pipeline(artifacts / "diffusion", lm_ckpt=artifacts / "lm", device="cpu")
    assert pipe.diffusion.module.unit_embed.weight.dtype == torch.bfloat16
    assert pipe.lm.module.enc_0.ff_in.weight.dtype == torch.bfloat16
    assert pipe.vocoder.generator.conv_pre.weight.dtype == torch.bfloat16


# -- verify_import ---------------------------------------------------------------------


def _args(path, **over):
    base = dict(path=str(path), kind="auto", heads=0, golden=None, save_golden=None, tol=1e-3, json=True)
    base.update(over)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def whisper_ckpt(tmp_path_factory):
    """A `{dims, model_state_dict}` checkpoint (the large-v3_encoder.pt layout)."""
    from tests.test_whisper_units import TINY, TorchWhisperEncoder

    torch.manual_seed(9)
    path = tmp_path_factory.mktemp("whisper") / "encoder.pt"
    torch.save({"dims": dataclasses.asdict(TINY),
                "model_state_dict": TorchWhisperEncoder(TINY).state_dict_reference_layout()}, path)
    return path


KINDS = {
    "codebook": ("semantic_codebook.pt", {}),
    "unit2mel": ("diffusion/model_77.pt", {}),
    "roformer": ("lm/model_55.pt", {"heads": 2}),
    "vaegan-encoder": ("vaegan/encoder.pth", {}),
    "vaegan-decoder": ("vaegan/decoder.pth", {}),
    "whisper": (None, {}),
}
SAME = ("kind", "geometry", "output_shape", "torch_keys_read", "torch_keys_unused", "torch_elements",
        "imported_elements")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_verify_matches_a_jax_golden(kind, artifacts, whisper_ckpt, tmp_path):
    rel, over = KINDS[kind]
    path = whisper_ckpt if rel is None else artifacts / rel
    golden = str(tmp_path / "g.npz")
    want = j_verify.verify(_args(path, save_golden=golden, **over))
    got = verify_import.verify(_args(path, golden=golden, tol=1e-4, device="cpu", **over))
    assert got["kind"] == kind and got["output_finite"]
    assert got["golden_match"] is True, got
    for key in SAME:
        assert got.get(key, "absent") == json.loads(json.dumps(want.get(key, "absent"), default=str)), key


def test_verify_pair_directory(artifacts):
    want = j_verify.verify(_args(artifacts / "vaegan"))
    got = verify_import.verify(_args(artifacts / "vaegan", device="cpu"))
    for half in ("encoder", "decoder"):
        assert got[half]["kind"] == want[half]["kind"] == f"vaegan-{half}"
        for key in SAME:
            assert got[half].get(key, "absent") == want[half].get(key, "absent"), (half, key)
    assert got["encoder"]["geometry"]["from_checkpoint_config"]


FINGERPRINTS = {
    "codebook": {"cluster_centers_": np.zeros((4, 8))},
    "whisper": {"dims": {}, "model_state_dict": {}},
    "whisper-bare": {"model": {"conv1.weight": 0, "blocks.0.attn.query.weight": 0}},
    "roformer": {"model": {"text_encoder.x": 0, "semantic_decoder.y": 0}},
    "llama": {"model": {"llama.model.layers.0.self_attn.q_proj.weight": 0}},
    "llama-bare": {"model.layers.0.mlp.up_proj.weight": 0},
    "unit2mel": {"model": {"unit_embed.weight": 0, "decoder.denoise_fn.conv_in.weight": 0}},
    "hubert": {"feature_extractor.conv_layers.0.conv.weight": 0, "encoder.layers.0.attention.q_proj.weight": 0},
    "wav2vec2": {"wav2vec2.encoder.x": 0},
    "w2vbert": {"encoder.layers.0.conv_module.x": 0},
    "bert": {"embeddings.word_embeddings.weight": 0, "encoder.layer.0.attention.self.query.weight": 0},
    "vaegan-encoder": {"model": {"ups.0.weight_v": 0, "conv_pre.weight_v": np.zeros((4, 1, 7))}},
    "vaegan-decoder": {"model": {"ups.0.weight_v": 0, "conv_pre.weight_v": np.zeros((4, 6, 7))}},
}


@pytest.mark.parametrize("case", sorted(FINGERPRINTS))
def test_detect_kind_matches_jax(case):
    obj = FINGERPRINTS[case]
    kind = verify_import.detect_kind(obj, "x")
    assert kind == j_verify.detect_kind(obj, "x") == case.split("-bare")[0]


def test_detect_kind_unknown_raises():
    with pytest.raises(ValueError, match="--kind"):
        verify_import.detect_kind({"model": {"mystery.weight": 0}}, "x")


@pytest.mark.parametrize("case,item", [("llama", "item 8"), ("bert", "item 6")])
def test_waiting_kinds_raise_naming_their_item(case, item, tmp_path):
    """The kinds that waited for their modules (Queue 1 `item`) now verify,
    with the JAX CLI's report: a Llama forward (geometry from the state
    dict, `--heads 2`), BERT's leaf statistics (the layers its state holds)."""
    from chip_smoke import reference_bert_state, reference_llama_state

    if case == "llama":
        from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaConfig, LlamaSystem

        cfg = LlamaConfig(hidden_size=16, num_attention_heads=2, num_hidden_layers=3, intermediate_size=24,
                          semantic_kmeans_num=20)
        state = reference_llama_state(LlamaSystem(cfg, device="cpu", seed=1).module.state_dict())
    else:
        from latent_diffusion_speech_tpu_torch.models.bert import BertConfig, BertEncoderModel
        from latent_diffusion_speech_tpu_torch.ops.layers import seeded

        cfg = BertConfig(vocab_size=40, hidden_size=16, num_hidden_layers=3, num_attention_heads=2,
                         intermediate_size=32, max_position_embeddings=24)
        state = reference_bert_state(seeded(lambda: BertEncoderModel(cfg), 1).state_dict(), pre_ln=False)
    torch.save({"model": state}, tmp_path / "x.pt")
    got = verify_import.verify(_args(tmp_path / "x.pt", heads=2, device="cpu"))
    want = j_verify.verify(_args(tmp_path / "x.pt", heads=2))
    assert got["kind"] == want["kind"] == case
    for key in ("geometry", "torch_keys_read", "torch_keys_unused", "torch_elements", "imported_elements",
                "output_shape", "output_finite"):
        assert got.get(key) == want.get(key), key
    for key in ("output_mean", "output_std"):
        assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-6), key


def _encoder_state(kind, layers=24):
    """A unit encoder's torch state dict at tiny widths with the published
    layer counts the JAX CLI assumes: bshall's HuBERT (packed in_proj,
    weight-normed positional conv), HF's Wav2Vec2Model, HF's
    Wav2Vec2BertModel."""
    rng = np.random.default_rng(len(kind))
    state = {}

    def put(name, *shape):
        state[name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def lin(name, o, i, bias=True):
        put(f"{name}.weight", o, i)
        if bias:
            put(f"{name}.bias", o)

    def ln(name, c):
        put(f"{name}.weight", c)
        put(f"{name}.bias", c)

    if kind == "hubert":
        for i in range(7):
            put(f"feature_extractor.conv{i}.weight", 8, 1 if i == 0 else 8, 3)
        ln("feature_extractor.norm0", 8)
        ln("feature_projection.norm", 8)
        lin("feature_projection.projection", 16, 8)
        put("positional_embedding.conv.weight_g", 1, 1, 4)
        put("positional_embedding.conv.weight_v", 16, 4, 4)
        put("positional_embedding.conv.bias", 16)
        ln("norm", 16)
        for i in range(12):
            b = f"encoder.layers.{i}"
            put(f"{b}.self_attn.in_proj_weight", 48, 16)
            put(f"{b}.self_attn.in_proj_bias", 48)
            lin(f"{b}.self_attn.out_proj", 16, 16)
            ln(f"{b}.norm1", 16)
            ln(f"{b}.norm2", 16)
            lin(f"{b}.linear1", 32, 16)
            lin(f"{b}.linear2", 16, 32)
        lin("proj", 8, 16)
        put("masked_spec_embed", 16)
        put("label_embedding.weight", 100, 8)
        return {"model": state}
    if kind == "wav2vec2":
        for i in range(7):
            put(f"feature_extractor.conv_layers.{i}.conv.weight", 8, 1 if i == 0 else 8, 3)
            put(f"feature_extractor.conv_layers.{i}.conv.bias", 8)
            ln(f"feature_extractor.conv_layers.{i}.layer_norm", 8)
        ln("feature_projection.layer_norm", 8)
        lin("feature_projection.projection", 16, 8)
        put("encoder.pos_conv_embed.conv.weight_g", 1, 1, 4)
        put("encoder.pos_conv_embed.conv.weight_v", 16, 4, 4)
        put("encoder.pos_conv_embed.conv.bias", 16)
        ln("encoder.layer_norm", 16)
        for i in range(layers):
            b = f"encoder.layers.{i}"
            ln(f"{b}.layer_norm", 16)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                lin(f"{b}.attention.{proj}", 16, 16)
            ln(f"{b}.final_layer_norm", 16)
            lin(f"{b}.feed_forward.intermediate_dense", 32, 16)
            lin(f"{b}.feed_forward.output_dense", 16, 32)
        return state
    ln("feature_projection.layer_norm", 160)
    lin("feature_projection.projection", 16, 160)
    for i in range(layers):
        b = f"encoder.layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            ln(f"{b}.{ffn}_layer_norm", 16)
            lin(f"{b}.{ffn}.intermediate_dense", 32, 16)
            lin(f"{b}.{ffn}.output_dense", 16, 32)
        ln(f"{b}.self_attn_layer_norm", 16)
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
            lin(f"{b}.self_attn.{proj}", 16, 16)
        put(f"{b}.self_attn.distance_embedding.weight", 11, 4)
        ln(f"{b}.conv_module.layer_norm", 16)
        put(f"{b}.conv_module.pointwise_conv1.weight", 32, 16, 1)
        put(f"{b}.conv_module.depthwise_conv.weight", 16, 1, 3)
        ln(f"{b}.conv_module.depthwise_layer_norm", 16)
        put(f"{b}.conv_module.pointwise_conv2.weight", 16, 16, 1)
        ln(f"{b}.final_layer_norm", 16)
    return state


@pytest.mark.parametrize("kind", ["hubert", "wav2vec2", "w2vbert"])
def test_unit_encoder_kinds_report_as_jax(kind, tmp_path):
    """Each unit encoder's checkpoint imports in the port and reports the
    JAX CLI's numbers (the first eight leaves' mean |x|), golden and all;
    the port also reads bshall's release layout (a `hubert` key), where the
    JAX CLI reads only `model`, and a checkpoint of fewer layers."""
    torch.save(_encoder_state(kind), tmp_path / "x.pt")
    golden = str(tmp_path / "g.npz")
    got = verify_import.verify(_args(tmp_path / "x.pt", kind=kind, device="cpu", save_golden=golden))
    want = j_verify.verify(_args(tmp_path / "x.pt", kind=kind))
    assert got["kind"] == want["kind"] == kind
    for key in ("output_shape", "output_mean", "output_std", "output_finite", "torch_elements"):
        assert got[key] == want[key], key
    assert got["output_shape"] == [8] and got["imported_elements"] == want["imported_elements"]
    assert j_verify.verify(_args(tmp_path / "x.pt", kind=kind, golden=golden))["golden_match"]
    if kind == "hubert":  # its depth is fixed
        torch.save({"hubert": _encoder_state(kind)["model"]}, tmp_path / "release.pt")
        release = verify_import.verify(_args(tmp_path / "release.pt", kind=kind, device="cpu"))
        assert release["output_mean"] == got["output_mean"]
    else:
        torch.save(_encoder_state(kind, layers=2), tmp_path / "x2.pt")
        short = verify_import.verify(_args(tmp_path / "x2.pt", kind=kind, device="cpu"))
        assert short["geometry"]["layers"] == 2 and short["output_mean"] == got["output_mean"]


def test_main_exit_codes(artifacts, tmp_path, capsys):
    path = str(artifacts / "lm" / "model_55.pt")
    golden = str(tmp_path / "g.npz")
    assert verify_import.main([path, "--heads", "2", "--save-golden", golden, "--json", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["kind"] == "roformer" and report["output_finite"]
    assert "semantic_decoder.cls.predictions.decoder.weight" in report["torch_keys_unused"]
    g = dict(np.load(golden, allow_pickle=True))
    g["output"] = np.asarray(g["output"]) + 1.0
    np.savez(golden, **g)
    assert verify_import.main([path, "--heads", "2", "--golden", golden, "--json", "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out)["golden_match"] is False
