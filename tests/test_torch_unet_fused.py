"""The port's fused whole-UNet forward (`ops/kernels/unet_fused.py`, the
counterpart of K2 `unet1d_fused.py::unet_fwd_pallas` and K3
`unet1d_stream.py::unet_fwd_pallas_stream`) on the CPU.

* the plan and the packed buffers agree with the module, and the kernel's
  record table with `csrc/unet_fwd.cu` (field names; every offset inside its
  buffer);
* a torch interpreter of the record table (what the kernel computes, record
  by record) against the plain version: this holds the table the kernel
  walks on the card to the plain arithmetic here;
* the plain version against the port's eager `UNet1D` in f32, atol 1e-5;
* the port in bf16 against the JAX kernels in interpret mode and the flax
  module, under the K2/K3 contract of tests/test_pallas_unet.py and
  tests/test_pallas_unet_stream.py: corr > 0.999 with the flax f32 output,
  max error <= max(4 x the flax bf16-vs-f32 error, 2% of scale);
* the sampler wiring (`unet_impl="pallas"` against `"xla"`, corr > 0.99,
  max |a-b| < 0.15 max(|a|, 1), tests/test_pallas_unet.py:89-108) and the
  eager route at B > 1.

Weights go across with `convert.unit2mel_from_jax`; the flax parameters are
drawn with numpy over `jax.eval_shape` of the init (kernels N(0, 1/fan_in),
norm scales and biases near 1 and 0: tests/test_torch_unet_zoo_blocks.py::draw),
since a flax init of these UNets costs tens of seconds; inputs are made with
numpy from a seed.
"""

import re
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from latent_diffusion_speech_tpu.models.diffusion.unet1d import UNet1D as JUNet1D
from latent_diffusion_speech_tpu.models.diffusion.unet1d import UNet1DConfig as JUNet1DConfig
from latent_diffusion_speech_tpu.ops.pallas.unet1d_fused import pack_unet_params as j_pack
from latent_diffusion_speech_tpu.ops.pallas.unet1d_fused import unet_fwd_pallas
from latent_diffusion_speech_tpu.ops.pallas.unet1d_stream import (
    pack_unet_params_stream,
    unet_fwd_pallas_stream,
)
from latent_diffusion_speech_tpu_torch.convert import unit2mel_from_jax
from latent_diffusion_speech_tpu_torch.models.diffusion import unit2mel
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1D, UNet1DConfig
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as uf
from latent_diffusion_speech_tpu_torch.ops.kernels.fused_attention import fused_attention_plain
from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype, seeded
from tests.test_torch_unet_zoo_blocks import draw

CONFIGS = {
    # tests/test_pallas_unet.py: TINY and the uneven-channel config
    "tiny": (dict(in_channels=24, out_channels=8, block_out_channels=(16, 24), layers_per_block=1,
                  n_heads=4, norm_num_groups=8), 16),
    "uneven": (dict(in_channels=16, out_channels=8, block_out_channels=(16, 32, 32), layers_per_block=2,
                    n_heads=4, norm_num_groups=8, cross_attn=(True, True, False)), 32),
    # tests/test_pallas_unet_stream.py:80-94: up-path concat wider than K3's row chunk
    "chunked_rows": (dict(in_channels=32, out_channels=16, block_out_channels=(256, 384), layers_per_block=1,
                          n_heads=4, norm_num_groups=8, cross_attn=(True, False)), 16),
}
T_STEP = 437.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small models: one intra-op thread (the parallel test run's workers
    would otherwise spin against each other on every small op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(name, dtype, seed=0):
    """A port UNet1D with weights perturbed away from the init (so every
    bias and norm parameter matters)."""
    cfg = UNet1DConfig(**CONFIGS[name][0])
    m = seeded(lambda: UNet1D(cfg), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return cfg, cast_compute_dtype(m, dtype).eval()


def _x(cfg, T, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((1, T, cfg.in_channels)).astype(np.float32))


def _f32(bits):
    return struct.unpack("<f", struct.pack("<i", bits))[0]


def run_table(packed, x, t):
    """Execute the kernel's record table with torch, record by record, as
    csrc/unet_fwd.cu computes it (f32 arithmetic, rounding to the storage
    dtype, statistics from the producers' sums)."""
    T = x.shape[1]
    tab = uf._table(packed, T)
    dt = packed.dtype
    f = {n: i for i, n in enumerate(uf.FIELDS)}
    stats = torch.full((tab.stats_elems,), float("nan"))
    bufs = {uf.BUF_WS: torch.full((tab.ws_elems,), float("nan")),
            uf.BUF_X: x[0].to(dt).float().reshape(-1),
            uf.BUF_Y: torch.full((T * packed.cfg.out_channels,), float("nan"))}
    W, P = packed.weights.float(), packed.params.float()
    ss = uf._scale_shift(packed, t).float()

    def r(v):
        return v.to(dt).float()

    def view(buf, off, ld, c, rows):
        return bufs[buf][off: off + rows * ld].view(rows, ld)[:, :c]

    for rec in tab.records.tolist():
        g = lambda n: rec[f[n]]  # noqa: E731
        rows = g("T_IN")
        if g("KIND") == uf.KIND_ATTN:
            C, H = g("N"), g("GROUPS")
            qkv = view(g("A_BUF"), g("A_OFF"), g("A_LD"), 3 * C, rows)
            q, k, v = (z.reshape(1, rows, H, C // H).to(dt) for z in qkv.split(C, dim=-1))
            o = fused_attention_plain(q, k, v, _f32(g("EPS")))[0].float().reshape(rows, C)
            view(g("OUT_BUF"), g("OUT_OFF"), g("OUT_LD"), C, rows)[:] = o
            continue
        assert g("KIND") == uf.KIND_GEMM
        pro = g("PRO")
        a = view(g("A_BUF"), g("A_OFF"), g("A_LD"), g("A_LD") if pro == uf.PRO_GEGLU else g("A_C"), rows)
        if g("B_C") > 0:
            a = torch.cat([a, view(g("B_BUF"), g("B_OFF"), g("B_LD"), g("B_C"), rows)], dim=-1)
        cin = a.shape[1]
        gamma, beta = P[g("GAMMA_OFF"):][:cin], P[g("BETA_OFF"):][:cin]
        if pro == uf.PRO_GEGLU:
            cin = g("A_C")
            a = r(a[:, :cin] * r(F.gelu(a[:, cin:])))
        elif pro == uf.PRO_GN:
            G, ca, cb, sa, sb = g("GROUPS"), g("A_C"), g("B_C"), g("CST_A"), g("CST_B")
            csum = torch.cat([stats[sa: sa + ca], stats[sb: sb + cb]])
            csq = torch.cat([stats[sa + ca: sa + 2 * ca], stats[sb + cb: sb + 2 * cb]])
            n = rows * (cin // G)
            mean = csum.view(G, -1).sum(-1) / n
            rstd = torch.rsqrt((csq.view(G, -1).sum(-1) / n - mean * mean).clamp_min(0) + _f32(g("EPS")))
            grp = torch.arange(cin) // (cin // G)
            a = r((a - mean[grp]) * rstd[grp] * gamma + beta)
            if g("SS_OFF") >= 0:
                so = g("SS_OFF")
                a = r(r(a * r(1 + ss[so: so + cin])) + ss[so + cin: so + 2 * cin])
        elif pro == uf.PRO_LN:
            ra = g("RST_A")
            mean = stats[ra: ra + rows][:, None] / cin
            var = (stats[ra + rows: ra + 2 * rows][:, None] / cin - mean * mean).clamp_min(0)
            a = r((a - mean) * torch.rsqrt(var + _f32(g("EPS"))) * gamma + beta)
        if g("SILU"):
            a = r(a / (1 + torch.exp(-a)))
        taps, n, mode, t_out = g("TAPS"), g("N"), g("MODE"), g("T_OUT")
        w = W[g("W_OFF"): g("W_OFF") + taps * cin * n].view(taps, cin, n)
        acc = torch.zeros(t_out, n)
        tt = torch.arange(t_out)
        for tap in range(taps):
            if mode == uf.MODES["down"]:
                src = 2 * tt + tap - 1
            elif mode == uf.MODES["up"]:
                u = tt + tap - 1
                src = torch.where((u >= 0) & (u < t_out), u // 2, torch.full_like(u, -1))
            else:
                src = tt + tap - taps // 2
            ok = (src >= 0) & (src < rows)
            acc += torch.where(ok[:, None], a[src.clamp(0, rows - 1)], torch.zeros(())) @ w[tap]
        if g("BIAS_OFF") >= 0:
            acc = acc + P[g("BIAS_OFF"): g("BIAS_OFF") + n]
        v = r(acc)
        if g("RES_OFF") >= 0:
            v = r(v + view(g("RES_BUF"), g("RES_OFF"), g("RES_LD"), n, t_out))
        view(g("OUT_BUF"), g("OUT_OFF"), g("OUT_LD"), n, t_out)[:] = v
        if g("RST_OUT") >= 0:
            so = g("RST_OUT")
            stats[so: so + t_out], stats[so + t_out: so + 2 * t_out] = v.sum(1), (v * v).sum(1)
        if g("CST_OUT") >= 0:
            so = g("CST_OUT")
            stats[so: so + n], stats[so + n: so + 2 * n] = v.sum(0), (v * v).sum(0)
    return bufs[uf.BUF_Y].view(1, T, -1).to(dt)


def test_fields_match_the_kernel_source():
    src = (Path(uf.__file__).parents[2] / "csrc" / "unet_fwd.cu").read_text()
    body = re.search(r"enum Field : int \{(.*?)\};", src, re.S).group(1)
    assert tuple(re.findall(r"F_([A-Z_]+)", body)) == uf.FIELDS
    assert int(re.search(r"constexpr int REC = (\d+);", src).group(1)) == uf.REC >= len(uf.FIELDS)
    assert int(re.search(r"constexpr int MAX_NORM_C = (\d+);", src).group(1)) == uf.MAX_NORM_C


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_and_packed_buffers_agree(name):
    cfg, m = _module(name, torch.bfloat16)
    packed = uf.pack_unet_params(m, cfg)
    params = dict(m.named_parameters())
    # every parameter except the time MLP is packed exactly once
    assert sorted(packed.sources) == sorted(n for n in params if not n.startswith("time_mlp"))
    sizes = {"w": packed.weights.numel(), "p": packed.params.numel()}
    for i, entry in enumerate(packed.layout):
        for key, (buf, off, shape) in entry.items():
            assert 0 <= off and off + int(np.prod(shape)) <= sizes[buf], (i, key)
    # values: conv kernels (3, in, out), matrices (in, out), q|k|v side by side
    res = next(i for i, op in enumerate(packed.ops) if isinstance(op, uf._Res))
    attn = next(i for i, op in enumerate(packed.ops) if isinstance(op, uf._Attn))
    rn, an = packed.ops[res].name, packed.ops[attn].name
    assert torch.equal(packed.get(res, "conv1"), params[rn + ".conv1.weight"].permute(2, 1, 0))
    assert torch.equal(packed.get(res, "n2_g"), params[rn + ".norm2.weight"])
    assert torch.equal(packed.get(attn, "qkv2")[:, -packed.ops[attn].c:], params[an + ".attn2.to_v.weight"].t())
    assert torch.equal(packed.get(attn, "b_ffp"), params[an + ".ff_proj.bias"].float())
    # the kernel's record table: every operand inside its buffer
    T = CONFIGS[name][1]
    tab = uf._table(packed, T)
    f = {n: i for i, n in enumerate(uf.FIELDS)}
    ends = {uf.BUF_WS: tab.ws_elems, uf.BUF_X: T * cfg.in_channels, uf.BUF_Y: T * cfg.out_channels}
    for rec in tab.records.tolist():
        g = lambda n: rec[f[n]]  # noqa: E731
        width = g("A_LD") if g("PRO") == uf.PRO_GEGLU else g("A_C")
        assert g("A_OFF") + (g("T_IN") - 1) * g("A_LD") + width <= ends[g("A_BUF")]
        if g("B_C"):
            assert g("B_OFF") + (g("T_IN") - 1) * g("B_LD") + g("B_C") <= ends[g("B_BUF")]
        rows_out = g("T_OUT") if g("KIND") == uf.KIND_GEMM else g("T_IN")
        assert g("OUT_OFF") + (rows_out - 1) * g("OUT_LD") + g("N") <= ends[g("OUT_BUF")]
        if g("KIND") == uf.KIND_GEMM:
            cin = g("A_C") + g("B_C")
            assert g("W_OFF") % 8 == 0 and g("W_OFF") + g("TAPS") * cin * g("N") <= sizes["w"]
            for key in ("CST_OUT", "RST_OUT"):
                assert g(key) < tab.stats_elems
    assert tab.phases == int(tab.records[:, f["SYNC"]].sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_record_table_matches_plain(name, dtype):
    """What the kernel computes, record by record, equals the plain version
    (f32: atol 1e-5; bf16: the same roundings, atol 1e-2 of scale for a
    rare tie broken the other way by a different summation order)."""
    cfg, m = _module(name, dtype)
    packed = uf.pack_unet_params(m, cfg)
    x, t = _x(cfg, CONFIGS[name][1]), torch.tensor([T_STEP])
    with torch.no_grad():
        ref = uf.unet_fwd_plain(packed, x, t, cfg).float()
        got = run_table(packed, x, t).float()
    atol = 1e-5 if dtype == torch.float32 else 1e-2 * ref.abs().max().item()
    torch.testing.assert_close(got, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_matches_eager_unet_f32(name):
    cfg, m = _module(name, torch.float32)
    packed = uf.pack_unet_params(m, cfg)
    x, t = _x(cfg, CONFIGS[name][1]), torch.tensor([T_STEP])
    with torch.no_grad():
        got = uf.unet_fwd(packed, x, t, cfg)      # CPU tensors: the plain version
        ref = m(x, t)
    assert got.shape == ref.shape == (1, x.shape[1], cfg.out_channels)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def _jax_refs(name, stream=False, seed=0):
    """flax bf16, flax f32 (same params) and the JAX kernel in interpret
    mode; plus the port's bf16 plain output on the same weights and x."""
    kw, T = CONFIGS[name]
    jcfg = JUNet1DConfig(**kw)
    x = np.random.default_rng(seed + 1).standard_normal((1, T, jcfg.in_channels)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    t = jnp.array([T_STEP], jnp.float32)
    mod = JUNet1D(jcfg, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(seed), xb, t)["params"]
    params = jax.tree_util.tree_map(jnp.asarray, draw(shapes, seed))
    # jitted: flax's eager apply and the packers compile op by op
    ref = np.asarray(jax.jit(mod.apply)({"params": params}, xb, t), np.float32)
    ref32 = np.asarray(jax.jit(JUNet1D(jcfg, dtype=jnp.float32).apply)({"params": params}, xb.astype(jnp.float32), t),
                       np.float32)
    pack, kernel = (pack_unet_params_stream, unet_fwd_pallas_stream) if stream else (j_pack, unet_fwd_pallas)
    kern = kernel(jax.jit(lambda p: pack(p, jcfg))(params), xb, t, jcfg, interpret=True)
    cfg = UNet1DConfig(**kw)
    m = seeded(lambda: UNet1D(cfg), 0)
    m.load_state_dict(unit2mel_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    packed = uf.pack_unet_params(cast_compute_dtype(m, torch.bfloat16).eval(), cfg)
    with torch.no_grad():
        got = uf.unet_fwd(packed, torch.from_numpy(x).bfloat16(), torch.tensor([T_STEP]), cfg)
    return got.float().numpy(), ref, ref32, np.asarray(kern, np.float32)


def _contract(got, ref, ref32, kern):
    scale = np.abs(ref32).max()
    bound = max(4 * np.abs(ref - ref32).max(), 0.02 * scale)
    assert np.corrcoef(got.ravel(), ref32.ravel())[0, 1] > 0.999
    assert np.abs(got - ref).max() <= bound, (np.abs(got - ref).max(), bound)
    assert np.abs(got - kern).max() <= bound, (np.abs(got - kern).max(), bound)


@pytest.mark.parametrize("name", ["tiny", "uneven"])
def test_port_matches_jax_fused_kernel(name):
    """Against K2 `unet_fwd_pallas(interpret=True)` and the flax module."""
    _contract(*_jax_refs(name))


def test_port_matches_jax_stream_kernel_chunked_rows():
    """Against K3 `unet_fwd_pallas_stream(interpret=True)` at the config
    whose up-path concat exceeds K3's 512-row weight chunks."""
    _contract(*_jax_refs("chunked_rows", stream=True))


U2M = dict(input_channel=16, n_spk=4, out_dims=8, n_hidden=16, block_out_channels=(16, 24), n_layers=1,
           n_heads=4, timesteps=50, k_step=50)


def _u2m_pair():
    xla = Unit2MelSystem(Unit2MelConfig(**U2M), dtype=torch.bfloat16, device="cpu", seed=0, unet_impl="xla")
    pal = Unit2MelSystem(Unit2MelConfig(**U2M), dtype=torch.bfloat16, device="cpu", seed=0, unet_impl="pallas")
    return xla, pal


def _spy(monkeypatch):
    calls = []
    real = unit2mel.unet_fwd

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(unit2mel, "unet_fwd", spy)
    return calls


def test_sampler_wiring_matches_eager(monkeypatch):
    """unet_impl='pallas' against 'xla' through the real sampler loop, B=1,
    the same weights and x_init."""
    calls = _spy(monkeypatch)
    xla, pal = _u2m_pair()
    rng = np.random.default_rng(7)
    units = torch.from_numpy(rng.standard_normal((1, 16, 16)).astype(np.float32))
    spk = torch.ones((1, 1), dtype=torch.long)
    x0 = torch.from_numpy(rng.standard_normal((1, 16, 8)).astype(np.float32))
    a = xla.infer(units, spk_id=spk, infer_speedup=10, x_init=x0).float().numpy()
    assert calls == []
    b = pal.infer(units, spk_id=spk, infer_speedup=10, x_init=x0).float().numpy()
    assert len(calls) == 5 and all(s[0] == 1 for s in calls)  # one per denoiser evaluation
    assert a.shape == b.shape == (1, 16, 8)
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.99
    assert np.abs(a - b).max() < 0.15 * max(np.abs(a).max(), 1.0)


def test_batched_infer_takes_the_eager_route(monkeypatch):
    calls = _spy(monkeypatch)
    _, pal = _u2m_pair()
    units = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 16, 16)).astype(np.float32))
    out = pal.infer(units, spk_id=torch.ones((2, 1), dtype=torch.long), infer_speedup=25,
                    generator=torch.Generator().manual_seed(7))
    assert calls == []
    assert out.shape == (2, 16, 8) and torch.isfinite(out.float()).all()


def test_unet_impl_values():
    xla, pal = _u2m_pair()
    auto = Unit2MelSystem(Unit2MelConfig(**U2M), device="cpu")
    assert auto.unet_impl == "auto" and auto._prepare_sample_params() is None
    assert xla._prepare_sample_params() is None
    assert isinstance(pal._prepare_sample_params(), uf.PackedUNet)
    with pytest.raises(ValueError, match="unet_impl"):
        Unit2MelSystem(Unit2MelConfig(**U2M), device="cpu", unet_impl="triton")
    with pytest.raises(ValueError, match="flagship"):
        Unit2MelSystem(Unit2MelConfig(denoiser="general", **U2M), device="cpu", unet_impl="pallas")


def test_unet_fwd_has_no_path_for_other_devices():
    cfg, m = _module("tiny", torch.float32)
    packed = uf.pack_unet_params(m, cfg)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        uf.unet_fwd(packed, torch.empty((1, 16, cfg.in_channels), device="meta"), torch.zeros(1))


def test_kernel_wrapper_rejects_shapes_it_does_not_take():
    """The checks `unet_fwd` runs before a launch: 8-channel vectors, the
    head dims of the attention routine, B=1, the downsample grid, at most
    MAX_NORM_C channels into a norm."""
    cfg, m = _module("tiny", torch.float32)
    packed = uf.pack_unet_params(m, cfg)
    with pytest.raises(ValueError, match="head dim 4"):
        uf._check(packed, _x(cfg, 16))
    with pytest.raises(ValueError, match=r"\(1, T, 24\)"):
        uf._check(packed, torch.zeros((2, 16, 24)))
    with pytest.raises(ValueError, match="multiple of 2"):
        uf._check(packed, torch.zeros((1, 15, 24)))
    odd = UNet1DConfig(in_channels=12, out_channels=8, block_out_channels=(64, 96), layers_per_block=1, n_heads=2)
    packed = uf.pack_unet_params(seeded(lambda: UNet1D(odd), 0), odd)
    with pytest.raises(ValueError, match="multiple of 8"):
        uf._check(packed, torch.zeros((1, 16, 12)))
    wide = UNet1DConfig(in_channels=8, out_channels=8, block_out_channels=(8, 520), layers_per_block=1, n_heads=8,
                        norm_num_groups=8)
    packed = uf.pack_unet_params(seeded(lambda: UNet1D(wide), 0), wide)
    with pytest.raises(ValueError, match="at most 1024 channels"):
        uf._check(packed, torch.zeros((1, 16, 8)))


@pytest.mark.slow
def test_port_matches_jax_fused_kernel_flagship():
    """Flagship width (256, 384, 512, 512) at T=64; chip_smoke.py holds the
    kernel itself at this width on the card."""
    CONFIGS["flagship"] = (dict(), 64)
    try:
        _contract(*_jax_refs("flagship"))
    finally:
        del CONFIGS["flagship"]
