"""The framework-free leftovers in the port against the JAX package: YIN f0
(`ops/f0.py`), MCD and LSD (`ops/metrics.py`) and the codec's module bag
(`models/vaegan/modules.py`: WN, ConvReluNorm, the Log and Flip flows, and
their importers).

Inputs come from a numpy seed; f32 on the CPU.  Tolerances: f0 within
rtol 1e-3 where both packages call a frame voiced, the voicing decisions
equal (the lags come from FFT correlations in another library);
`_dct2` atol 1e-5 (tests/test_metrics.py against scipy), MCD and LSD rtol
1e-5; the modules atol 1e-5 (tests/test_vaegan_modules.py against the
reference), the importers' trees bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.vaegan import modules as j_modules
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.models.vaegan.modules import (
    ConvReluNorm1D,
    WN1D,
    conv_relu_norm_params_from_torch,
    flip_flow,
    log_flow,
    wn_params_from_torch,
)
from latent_diffusion_speech_tpu_torch.ops import metrics
from latent_diffusion_speech_tpu_torch.ops.f0 import extract_f0

# `ops/__init__.py` re-exports functions under the modules' names
j_f0 = importlib.import_module("latent_diffusion_speech_tpu.ops.f0")
j_metrics = importlib.import_module("latent_diffusion_speech_tpu.ops.metrics")

SR = 44100


def _tone(freq, seconds=0.6, amp=0.5, sr=SR):
    t = np.arange(int(sr * seconds)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _signals(rng):
    return {
        "tones": np.stack([_tone(f) for f in (110.0, 220.0, 440.0, 880.0)]),
        "mixed": np.concatenate([_tone(220.0, 0.3), np.zeros(int(0.3 * SR), np.float32)])[None],
        "noise": (0.1 * rng.standard_normal((1, int(0.6 * SR)))).astype(np.float32),
        "silence": np.zeros((1, 8000), np.float32),
        "glide": np.sin(2 * np.pi * np.cumsum(np.linspace(150, 300, int(0.6 * SR))) / SR)[None].astype(np.float32),
    }


@pytest.mark.parametrize("hop,win", [(512, 2048), (256, 1024)])
def test_extract_f0_matches_jax(rng, hop, win):
    for name, audio in _signals(rng).items():
        f0, voiced = extract_f0(torch.from_numpy(audio), hop_size=hop, win_size=win)
        jf0, jvoiced = j_f0.extract_f0(jnp.asarray(audio), hop_size=hop, win_size=win)
        assert f0.shape == voiced.shape == (audio.shape[0], audio.shape[1] // hop + 1), name
        assert f0.dtype == torch.float32 and voiced.dtype == torch.bool
        np.testing.assert_array_equal(voiced.numpy(), np.asarray(jvoiced), err_msg=name)
        both = voiced.numpy() & np.asarray(jvoiced)
        np.testing.assert_allclose(f0.numpy()[both], np.asarray(jf0)[both], rtol=1e-3, err_msg=name)
        assert (f0.numpy()[~voiced.numpy()] == 0).all()
    f0, voiced = extract_f0(torch.from_numpy(_tone(220.0)))  # one signal: no batch axis
    assert f0.dim() == 1 and abs(float(np.median(f0.numpy()[voiced.numpy()])) - 220.0) < 2.0


def test_metrics_match_jax(rng):
    from scipy.fft import dct

    x = rng.standard_normal((4, 32)).astype(np.float32)
    np.testing.assert_allclose(metrics._dct2(torch.from_numpy(x)).numpy(), dct(x, type=2, norm="ortho", axis=-1),
                               atol=1e-5)
    a = rng.standard_normal((2, 50, 128)).astype(np.float32)
    b = a + 0.1 * rng.standard_normal((2, 50, 128)).astype(np.float32) + np.linspace(0, 1, 128, dtype=np.float32)
    for fn, kw in (("mcd", {}), ("mcd", {"n_coeffs": 24}), ("log_spectral_distance", {})):
        got = getattr(metrics, fn)(torch.from_numpy(a), torch.from_numpy(b), **kw)
        want = getattr(j_metrics, fn)(jnp.asarray(a), jnp.asarray(b), **kw)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, err_msg=fn)
    assert metrics.mcd(torch.from_numpy(a), torch.from_numpy(a + 1.0)).item() == pytest.approx(0.0, abs=1e-4)


B, C, T = 2, 12, 40


def _weight_norm(rng, name, out_ch, in_ch, k, state):
    state[f"{name}.weight_g"] = torch.from_numpy(rng.uniform(0.5, 1.5, (out_ch, 1, 1)).astype(np.float32))
    state[f"{name}.weight_v"] = torch.from_numpy(rng.standard_normal((out_ch, in_ch, k)).astype(np.float32))
    state[f"{name}.bias"] = torch.from_numpy(0.1 * rng.standard_normal(out_ch).astype(np.float32))


def _data(rng):
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = (rng.random((B, T, 1)) > 0.2).astype(np.float32)
    return x, mask


def _tree_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(jax.tree_util.tree_leaves(a),
                                                                jax.tree_util.tree_leaves(b)))


@pytest.mark.parametrize("dilation_rate,n_layers", [(2, 4), (1, 2)])
def test_wn_matches_jax(rng, dilation_rate, n_layers):
    """The reference's weight-normed WN state dict through both importers,
    then both modules on a masked batch."""
    state = {}
    for i in range(n_layers):
        _weight_norm(rng, f"in_layers.{i}", 2 * C, C, 3, state)
        _weight_norm(rng, f"res_skip_layers.{i}", 2 * C if i < n_layers - 1 else C, C, 1, state)
    mine, theirs = wn_params_from_torch(state), j_modules.wn_params_from_torch(state)
    _tree_equal(mine, theirs)
    m = WN1D(C, 3, dilation_rate, n_layers)
    m.load_state_dict(convert.vaegan_modules_from_jax(mine))
    x, mask = _data(rng)
    want = j_modules.WN1D(C, 3, dilation_rate, n_layers).apply({"params": theirs}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert (got.numpy()[np.broadcast_to(mask, got.shape) == 0] == 0).all()
    # dropout only with a generator, repeatable for one seed
    with torch.no_grad():
        a = m(torch.from_numpy(x), torch.from_numpy(mask), torch.Generator().manual_seed(0), 0.5)
        b = m(torch.from_numpy(x), torch.from_numpy(mask), torch.Generator().manual_seed(0), 0.5)
        off = m(torch.from_numpy(x), torch.from_numpy(mask), None, 0.5)
    assert torch.equal(a, b) and not torch.allclose(a, got) and torch.equal(off, got)


def test_conv_relu_norm_matches_jax(rng):
    state = {}
    for i in range(3):
        w = rng.standard_normal((16, C if i == 0 else 16, 5)).astype(np.float32) * 0.3
        state[f"conv_layers.{i}.weight"] = torch.from_numpy(w)
        state[f"conv_layers.{i}.bias"] = torch.from_numpy(0.1 * rng.standard_normal(16).astype(np.float32))
        state[f"norm_layers.{i}.gamma"] = torch.from_numpy(rng.uniform(0.5, 1.5, 16).astype(np.float32))
        state[f"norm_layers.{i}.beta"] = torch.from_numpy(0.1 * rng.standard_normal(16).astype(np.float32))
    state["proj.weight"] = torch.from_numpy(0.2 * rng.standard_normal((C, 16, 1)).astype(np.float32))
    state["proj.bias"] = torch.from_numpy(0.1 * rng.standard_normal(C).astype(np.float32))
    mine, theirs = conv_relu_norm_params_from_torch(state), j_modules.conv_relu_norm_params_from_torch(state)
    _tree_equal(mine, theirs)
    m = ConvReluNorm1D(C, 16, C, 5, 3)
    assert not m.proj.weight.any() and not m.proj.bias.any()  # zero-initialised, as JAX's
    m.load_state_dict(convert.vaegan_modules_from_jax(mine))
    x, mask = _data(rng)
    want = j_modules.ConvReluNorm1D(16, C, 5, 3).apply({"params": theirs}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(AssertionError):
        ConvReluNorm1D(C, 16, C, 5, 1)


def test_flows_match_jax(rng):
    x, mask = _data(rng)
    pos = np.abs(x) + 0.1
    y, ld = log_flow(torch.from_numpy(pos), torch.from_numpy(mask))
    jy, jld = j_modules.log_flow(jnp.asarray(pos), jnp.asarray(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=1e-5)
    np.testing.assert_allclose(log_flow(y, torch.from_numpy(mask), reverse=True).numpy(),
                               np.asarray(j_modules.log_flow(jy, jnp.asarray(mask), reverse=True)), rtol=1e-6)
    f, fld = flip_flow(torch.from_numpy(x))
    jf, jfld = j_modules.flip_flow(jnp.asarray(x))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert not fld.any() and fld.shape == jfld.shape
    np.testing.assert_array_equal(flip_flow(f, reverse=True).numpy(), x)
