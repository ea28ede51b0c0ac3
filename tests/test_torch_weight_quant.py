"""int8 serving weights (`ops/weight_quant.py`) against the JAX package's.

* The int8 values and bf16 scales of a Unit2Mel's UNet equal JAX's
  `quantize_tree_int8` on the same parameters (the port's output channel
  is dim 0 where flax's is the last axis), exactly;
* JAX's unit bounds: the round-trip error within a scale (plus the bf16
  scale's rounding), small and 1-D leaves passing through;
* the port's int8 sampler (`Unit2MelSystem(weight_quant="int8")`, f32
  compute) against JAX's int8 sampler from the same x_init, at the sampler
  tolerance of tests/test_torch_pipeline.py (atol / rtol 2e-3);
* int8 against the port's own bf16 sampler: correlation above 0.99 (JAX's
  bar in tests/test_weight_quant.py);
* JAX's ValueErrors: another value, with unet_impl="pallas", with the
  general denoiser;
* `build_pipeline` with `common.infer.weight_quant: int8` builds and
  serves a `tts`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelSystem as JUnit2MelSystem
from latent_diffusion_speech_tpu.ops.weight_quant import QuantizedLeaf as JQuantizedLeaf
from latent_diffusion_speech_tpu.ops.weight_quant import quantize_tree_int8 as j_quantize
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.ops.weight_quant import (
    QuantizedLeaf,
    dequantize_tree,
    quantize_tree_int8,
    tree_bytes,
)

# wide enough that the GEGLU, the attention and several convolutions reach 4096 elements
U2M = dict(input_channel=16, n_spk=4, out_dims=8, n_hidden=16, block_out_channels=(32, 48), n_layers=1,
           n_heads=4, timesteps=50, k_step=50)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def systems():
    jsys = JUnit2MelSystem(JUnit2MelConfig(**U2M), seed=0)
    params = jax.tree_util.tree_map(np.asarray, jsys.params)
    state = convert.unit2mel_from_jax(params)
    return jsys, params, state


def test_int8_values_and_scales_equal_jax(systems):
    jsys, params, state = systems
    jq = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
        j_quantize(params["unet"]), is_leaf=lambda x: isinstance(x, JQuantizedLeaf))[0]}
    port = quantize_tree_int8({k[len("unet."):]: v for k, v in state.items() if k.startswith("unet.")})
    n = 0
    for path, leaf in jq.items():
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + ["weight" if keys[-1] in ("kernel", "scale", "embedding") else keys[-1]])
        got = port[name]
        if not isinstance(leaf, JQuantizedLeaf):
            assert not isinstance(got, QuantizedLeaf), name
            continue
        n += 1
        q, scale = np.asarray(leaf.q), np.asarray(leaf.scale.astype(jnp.float32))
        perm = tuple(reversed(range(q.ndim)))  # flax (in, out) / (k, in, out) -> torch (out, in) / (out, in, k)
        np.testing.assert_array_equal(got.q.numpy(), np.transpose(q, perm), err_msg=name)
        np.testing.assert_array_equal(got.scale.float().numpy(), np.transpose(scale, perm), err_msg=name)
        assert got.q.dtype == torch.int8 and got.scale.dtype == torch.bfloat16
    assert n >= 8


def test_roundtrip_error_bound():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((96, 64, 3)).astype(np.float32)) * 0.1
    q = quantize_tree_int8({"conv.weight": w, "conv.bias": torch.zeros(96)}, min_size=1024)
    assert isinstance(q["conv.weight"], QuantizedLeaf) and q["conv.weight"].q.dtype == torch.int8
    assert not isinstance(q["conv.bias"], QuantizedLeaf)
    d = dequantize_tree(q, dtype=torch.float32)
    scale = w.abs().amax(dim=(1, 2)) / 127.0
    err = (d["conv.weight"] - w).abs()
    assert (err <= scale[:, None, None] * 1.05 + 1e-6).all()


def test_small_leaves_pass_through():
    tree = {"scale": torch.ones(64), "tiny": torch.ones(4, 4)}
    q = quantize_tree_int8(tree, min_size=4096)
    assert not any(isinstance(v, QuantizedLeaf) for v in q.values())
    assert torch.equal(dequantize_tree(q)["scale"], tree["scale"])
    assert tree_bytes(q) == 64 * 4 + 16 * 4


@pytest.fixture(scope="module")
def x_init():
    return np.random.default_rng(5).standard_normal((1, 16, U2M["out_dims"])).astype(np.float32)


def _units():
    g = np.random.default_rng(3)
    return g.standard_normal((1, 16, U2M["input_channel"])).astype(np.float32), np.ones((1, 16), np.int32)


def test_int8_sampler_matches_jax_int8_sampler(systems, x_init):
    jsys, params, state = systems
    jq = JUnit2MelSystem(JUnit2MelConfig(**U2M), params=jsys.params, weight_quant="int8")
    units, spk = _units()
    want = np.asarray(jq.infer(jnp.asarray(units), jax.random.PRNGKey(0), spk_id=jnp.asarray(spk),
                               method="dpm-solver", infer_speedup=10, x_init=jnp.asarray(x_init)))
    port = Unit2MelSystem(Unit2MelConfig(**U2M), state_dict=state, device="cpu", weight_quant="int8")
    got = port.infer(torch.from_numpy(units), torch.Generator().manual_seed(0), spk_id=torch.from_numpy(spk).long(),
                     method="dpm-solver", infer_speedup=10, x_init=torch.from_numpy(x_init))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    # and int8 moved the result: the f32 sampler differs by more than the tolerance
    fp = Unit2MelSystem(Unit2MelConfig(**U2M), state_dict=state, device="cpu")
    ref = fp.infer(torch.from_numpy(units), torch.Generator().manual_seed(0), spk_id=torch.from_numpy(spk).long(),
                   method="dpm-solver", infer_speedup=10, x_init=torch.from_numpy(x_init))
    assert (ref - got).abs().max().item() > 2e-3


def test_int8_correlates_with_bf16(systems, x_init):
    _, _, state = systems
    units, spk = _units()
    outs = []
    for quant in (None, "int8"):
        s = Unit2MelSystem(Unit2MelConfig(**U2M), state_dict=state, dtype=torch.bfloat16, device="cpu",
                           weight_quant=quant)
        outs.append(s.infer(torch.from_numpy(units), torch.Generator().manual_seed(0),
                            spk_id=torch.from_numpy(spk).long(), method="dpm-solver", infer_speedup=10,
                            x_init=torch.from_numpy(x_init)).float().numpy())
    corr = np.corrcoef(outs[0].ravel(), outs[1].ravel())[0, 1]
    assert corr > 0.99, corr


@pytest.mark.parametrize("case", ["value", "pallas", "general"])
def test_weight_quant_validation(case):
    cfg = Unit2MelConfig(**U2M)
    kw = {"value": dict(weight_quant="fp4"), "pallas": dict(weight_quant="int8", unet_impl="pallas"),
          "general": dict(weight_quant="int8")}[case]
    if case == "general":
        import dataclasses

        cfg = dataclasses.replace(cfg, denoiser="general")
    with pytest.raises(ValueError):
        Unit2MelSystem(cfg, device="cpu", **kw)


def test_build_pipeline_with_int8_serves(tmp_path, monkeypatch):
    from latent_diffusion_speech_tpu_torch import config
    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline
    from latent_diffusion_speech_tpu_torch.models.vaegan import config as vaegan_config
    from tests.test_torch_serve_entry import CONFIG, TEXT, VAEGAN, _tiny

    real = vaegan_config.VAEGANConfig
    monkeypatch.setattr(vaegan_config, "VAEGANConfig", lambda: real(**VAEGAN))
    cfg = _tiny(config.load_config(CONFIG), tmp_path)
    cfg.common.infer.weight_quant = "int8"
    pipe = build_pipeline(cfg, dtype=torch.float32, device="cpu")
    assert pipe.diffusion.weight_quant == "int8"
    wav, sr = pipe.tts(TEXT, language="EN", max_length=16, infer_speedup=100)
    assert len(wav) > 0 and np.isfinite(wav).all()
