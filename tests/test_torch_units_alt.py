"""HuBERT-soft in the port against the JAX package, the seeded encoders,
and stage 10 with `encoder: hubert_soft`.

f32 on the CPU, audio made with numpy from a seed.  Weights go across
through `convert.py` and through the importer from bshall's layout (a
torch module of the reference architecture built here: packed `in_proj`,
a weight-normed positional conv), which is also the oracle.  HuBERT-soft
has no smaller geometry: it runs at its full width (12 x 768) on 0.5 s of
audio, the JAX module's units computed once for the module.  Tolerance:
the JAX package's own parity one, atol 5e-4 / rtol 1e-3 on the units.
XLSR-53 and w2v-BERT 2.0 are in tests/test_torch_units_w2v.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from latent_diffusion_speech_tpu.models import hubert as j_hubert
from latent_diffusion_speech_tpu.models.units import UnitsEncoder as JUnitsEncoder
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.models import hubert, w2vbert, wav2vec2
from latent_diffusion_speech_tpu_torch.models import units as port_units
from latent_diffusion_speech_tpu_torch.models.units import (
    HubertSoftUnits,
    UnitsEncoder,
    Wav2Vec2BertUnits,
    XLSRUnits,
)

J_unit_cli = importlib.import_module("latent_diffusion_speech_tpu.cli.preprocess_unit")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=tol[0], rtol=tol[1])


HUBERT_TOL = (5e-4, 1e-3)


# -- HuBERT-soft ---------------------------------------------------------------

class BshallHubert(nn.Module):
    """bshall's `HubertSoft` layout (tests/test_hubert.py's oracle)."""

    def __init__(self):
        super().__init__()
        self.feature_extractor = nn.Module()
        for i, (k, s) in enumerate([(10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2)]):
            setattr(self.feature_extractor, f"conv{i}", nn.Conv1d(1 if i == 0 else 512, 512, k, s, bias=False))
        self.feature_extractor.norm0 = nn.GroupNorm(512, 512)
        self.feature_projection = nn.Module()
        self.feature_projection.norm = nn.LayerNorm(512)
        self.feature_projection.projection = nn.Linear(512, 768)
        self.positional_embedding = nn.Module()
        self.positional_embedding.conv = nn.utils.parametrizations.weight_norm(
            nn.Conv1d(768, 768, 128, padding=64, groups=16), name="weight", dim=2)
        self.norm = nn.LayerNorm(768)
        self.encoder = nn.TransformerEncoder(
            nn.TransformerEncoderLayer(768, 12, 3072, activation="gelu", batch_first=True, dropout=0.0),
            12, enable_nested_tensor=False)
        self.proj = nn.Linear(768, 256)
        self.masked_spec_embed = nn.Parameter(torch.rand(768))
        self.label_embedding = nn.Embedding(100, 256)

    def units(self, wav):
        x = F.pad(wav, (40, 40))[:, None, :]
        fe = self.feature_extractor
        x = F.gelu(fe.norm0(fe.conv0(x)))
        for i in range(1, 7):
            x = F.gelu(getattr(fe, f"conv{i}")(x))
        x = self.feature_projection.projection(self.feature_projection.norm(x.transpose(1, 2)))
        pe = self.positional_embedding.conv(x.transpose(1, 2))
        x = self.norm(x + F.gelu(pe[:, :, :-1]).transpose(1, 2))
        return self.proj(self.encoder(x))


@pytest.fixture(scope="module")
def bshall():
    torch.manual_seed(0)
    return BshallHubert().eval()


@pytest.fixture(scope="module")
def jax_hubert(bshall):
    """The JAX module over bshall's weights (its importer), and its units
    of 0.5 s of audio."""
    m = j_hubert.HubertSoft()
    params = jax.tree_util.tree_map(jnp.asarray, j_hubert.hubert_params_from_torch(bshall.state_dict()))
    wav = (np.random.default_rng(0).standard_normal((1, 8000)) * 0.1).astype(np.float32)
    units = jax.jit(lambda p, w: m.apply({"params": p}, w, method=m.units))(params, jnp.asarray(wav))
    return m, params, wav, np.asarray(units)


def test_hubert_units_from_the_jax_tree(jax_hubert):
    _, params, wav, ref = jax_hubert
    port = hubert.HubertSoft()
    port.load_state_dict(convert.hubert_from_jax(_np_tree(params)))
    with torch.no_grad():
        got = port.eval().units(torch.from_numpy(wav))
    assert got.shape == (1, 25, 256)
    _close(got, ref, HUBERT_TOL)


def test_hubert_bshall_import_matches_jax_and_the_oracle(bshall, jax_hubert):
    _, params, wav, ref = jax_hubert
    state = bshall.state_dict()
    jax.tree_util.tree_map(np.testing.assert_array_equal, hubert.hubert_params_from_torch(state),
                           j_hubert.hubert_params_from_torch(state))
    port = hubert.HubertSoft()
    port.load_state_dict(hubert.hubert_state_from_torch(state))
    with torch.no_grad():
        got = port.eval().units(torch.from_numpy(wav))
        oracle = bshall.units(torch.from_numpy(wav))
    _close(got, ref, HUBERT_TOL)
    _close(got, oracle, HUBERT_TOL)


def test_hubert_logits_with_a_span_mask_match_jax(jax_hubert):
    m, params, _, _ = jax_hubert
    wav = (np.random.default_rng(1).standard_normal((2, 4000)) * 0.1).astype(np.float32)
    port = hubert.HubertSoft()
    port.load_state_dict(convert.hubert_from_jax(_np_tree(params)))
    mask = hubert.compute_span_mask(torch.Generator().manual_seed(0), (2, 12), 0.5, 3, 2)
    assert mask.shape == (2, 12) and 0 < mask.float().mean() < 1
    jl, ju = jax.jit(lambda p, w, s: m.apply({"params": p}, w, span_mask=s))(
        params, jnp.asarray(wav), jnp.asarray(mask.numpy()))
    with torch.no_grad():
        pl, pu = port.eval()(torch.from_numpy(wav), span_mask=mask)
    _close(pu, ju, HUBERT_TOL)
    _close(pl, jl, (2e-3, 1e-3))  # cosine / 0.1: ten times the units' scale
    assert float(pl.abs().max()) <= 10.0 + 1e-4


def test_span_mask_counts_spans_as_jax():
    mask = hubert.compute_span_mask(torch.Generator().manual_seed(3), (64, 100), 0.8, 10, 2)
    jmask = np.asarray(j_hubert.compute_span_mask(jax.random.PRNGKey(3), (64, 100), 0.8, 10, 2))
    # eight 10-frame spans with uniform starts cover the same share in law
    assert abs(float(mask.float().mean()) - float(jmask.mean())) < 0.05
    tiny = hubert.compute_span_mask(torch.Generator().manual_seed(0), (2, 6), 0.8, 10, 2)
    assert tiny.all()  # spans past the end are dropped, as JAX's scatter drops them


# -- UnitsEncoder and stage 10 ---------------------------------------------------

@pytest.fixture(scope="module")
def bshall_ckpt(bshall, tmp_path_factory):
    path = tmp_path_factory.mktemp("hubert") / "hubert-soft.pt"
    torch.save({"hubert": bshall.state_dict()}, path)
    return path


def _encoders(bshall_ckpt):
    return (JUnitsEncoder("hubert_soft", ckpt_path=str(bshall_ckpt), dtype=jnp.float32),
            UnitsEncoder("hubert_soft", ckpt_path=str(bshall_ckpt), dtype=torch.float32, device="cpu"))


def test_units_encoder_encode_matches_jax(bshall_ckpt):
    jue, ue = _encoders(bshall_ckpt)
    assert type(ue.model) is HubertSoftUnits
    wav = (np.random.default_rng(4).standard_normal(14000) * 0.1).astype(np.float32)  # 0.7 s at 20 kHz
    got = ue.encode(wav, 20000)
    assert got.shape == (1, int(14000 * 16000 / 20000) // 320, 256)
    _close(got, jue.encode(jnp.asarray(wav), 20000), HUBERT_TOL)


def test_seeded_encoders_without_weights(tmp_path, capsys, monkeypatch):
    """No checkpoint and no local HF cache: each encoder is seeded at full
    width on the asked device (the builds are stubbed here: 0.1, 0.3 and
    0.6 G parameters; tests/test_torch_init.py checks the seeded leaves)."""
    built = []

    def stub(factory, device, state, seed, dtype):
        with torch.device("meta"):
            built.append((type(factory()), device.type, state, seed, dtype))

    monkeypatch.setattr(port_units, "_built", stub)
    h = HubertSoftUnits(str(tmp_path / "none.pt"), seed=2, device="meta")
    w = Wav2Vec2BertUnits(cache_dir=str(tmp_path / "no-cache"), seed=3, device="meta")
    x = XLSRUnits(None, device="meta")
    assert capsys.readouterr().out.count("seeded random weights") == 3
    assert w.cfg == w2vbert.W2vBertConfig() and x.cfg == wav2vec2.Wav2Vec2Config()  # full width
    assert built == [(hubert.HubertSoft, "meta", None, 2, torch.bfloat16),
                     (w2vbert.W2vBertModel, "meta", None, 3, torch.bfloat16),
                     (wav2vec2.Wav2Vec2Encoder, "meta", None, 0, torch.bfloat16)]
    assert h.device.type == "meta"


def test_stage_10_with_hubert_soft_matches_jax(tmp_path, bshall_ckpt):
    from latent_diffusion_speech_tpu_torch.cli import preprocess_unit
    from latent_diffusion_speech_tpu_torch.ops import audio_io

    root = tmp_path / "train"
    rng = np.random.default_rng(5)
    for name, n in (("a", 7000), ("b", 12100)):
        (root / "audio" / "1").mkdir(parents=True, exist_ok=True)
        audio_io.write_wav(root / "audio" / "1" / f"{name}.wav", (rng.standard_normal(n) * 0.1).astype(np.float32),
                           16000)
    jue, ue = _encoders(bshall_ckpt)
    got = dict(preprocess_unit.process_units(root, ue, 16000))
    saved = {n: np.load(root / "units" / (n + ".npy")) for n in got}
    ref = dict(J_unit_cli.process_units(root, jue, 16000))
    assert got == ref and {n: s[1] for n, s in got.items()} == {n: 256 for n in got}
    for n in got:
        _close(saved[n], np.load(root / "units" / (n + ".npy")), HUBERT_TOL)
