"""The bf16 tensor-core attention kernels (`csrc/attention_mma.cuh`, K5
`flash_attention_bf16` and K4 `attention_fwd_bf16`) on the CPU.

The kernels themselves run only on the card (tests/test_torch_kernels_cuda.py).
Here a plain-PyTorch model of each kernel's arithmetic, written below, is
held to the JAX Pallas kernel it replaces, run in interpret mode in bf16 as
tests/test_pallas.py runs it.  The models follow the kernels step by step: a
warp's 16 query rows walk the keys in 64-key tiles in log2 units; K5 keeps
one online-softmax update per tile and splits the f32 p into two bf16 parts
for p @ v; K4 takes (m, l) in a first pass and rounds the normalised p to
bf16 in a second.  At most 2% of the bf16 outputs may differ from the JAX
kernel's; a K5 variant that rounds p to bf16, and a K4 variant that rounds
p before normalising, each change at least 20%, so the bound tells the
numerics apart.  Inputs are made with numpy from a seed.

The wrappers' launch plan runs on CPU tensors: `plan` (checks, the entry
by dtype, the strides, 16-byte alignment for bf16) and `launch_args` (the
packed struct each C entry takes); `build.entry` sets a C function's
argument types once per library.
"""

import ctypes
import re
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from latent_diffusion_speech_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from latent_diffusion_speech_tpu.ops.pallas.fused_attention import _fused_fwd as j_fused_fwd
from latent_diffusion_speech_tpu.ops.pallas.fused_attention import fused_attention as j_fused
from latent_diffusion_speech_tpu_torch.ops.kernels import build
from latent_diffusion_speech_tpu_torch.ops.kernels import flash_attention as k5
from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

WARP_ROWS, TILE_KEYS = 16, 64
LOG2E = float(np.float32(1.4426950408889634))
LN2 = float(np.float32(0.6931471805599453))


def _bf16(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32).astype(jnp.bfloat16)


def _heads(x):
    """(B, T, H, D) bf16 numpy -> (B, H, T, D) f32 torch."""
    return torch.from_numpy(np.asarray(x, np.float32)).transpose(1, 2)


def _scores(q, k, key0, scale_log2, kv_len, rows, causal):
    """One tile's scores of a warp's rows in log2 units, masked to -inf
    (keys at or past kv_len; causal: key > row, top-left)."""
    kt = k[..., key0: key0 + TILE_KEYS, :]
    s = (q @ kt.transpose(-1, -2)) * scale_log2
    keys = torch.arange(key0, key0 + kt.shape[-2])
    keep = keys[None, :] < kv_len
    if causal:
        keep = keep & (keys[None, :] <= rows[:, None])
    return s.masked_fill(~keep, float("-inf"))


def online_update(s, m, l, acc):
    """One tile's FlashAttention-2 update of (m, l, acc) as the K5 kernel
    makes it; returns (m_new, p, l_new, acc rescaled).  A row whose keys are
    all masked so far subtracts 0, not -inf, so it keeps m = -inf, p = 0,
    l = 0 and acc = 0 instead of turning NaN."""
    m_new = torch.maximum(m, s.amax(-1))
    m_use = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
    alpha = torch.exp2(m - m_use)
    p = torch.exp2(s - m_use[..., None])
    return m_new, p, l * alpha + p.sum(-1), acc * alpha[..., None]


def k5_model(q, k, v, causal=False, p_bf16=False):
    """The K5 tensor-core kernel's arithmetic on bf16 numpy (B, T, H, D)
    inputs; p_bf16 rounds p to bf16 for p @ v instead of splitting it."""
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    Tq, Tkv, D = qh.shape[-2], kh.shape[-2], qh.shape[-1]
    scale_log2 = float(np.float32(D**-0.5) * np.float32(LOG2E))
    out = torch.empty_like(qh)
    for r0 in range(0, Tq, WARP_ROWS):
        rows = torch.arange(r0, min(r0 + WARP_ROWS, Tq))
        m = torch.full(qh.shape[:2] + (len(rows),), float("-inf"))
        l = torch.zeros_like(m)
        acc = torch.zeros(qh.shape[:2] + (len(rows), D))
        kv_warp = min(Tkv, r0 + WARP_ROWS) if causal else Tkv
        for key0 in range(0, kv_warp, TILE_KEYS):
            s = _scores(qh[..., rows, :], kh, key0, scale_log2, Tkv, rows, causal)
            m, p, l, acc = online_update(s, m, l, acc)
            vt = vh[..., key0: key0 + TILE_KEYS, :]
            hi = p.bfloat16().float()
            if p_bf16:
                acc = acc + hi @ vt
            else:
                acc = acc + hi @ vt + (p - hi).bfloat16().float() @ vt
        out[..., rows, :] = acc / l.clamp_min(1e-30)[..., None]
    return out.bfloat16().transpose(1, 2)


def k4_model(q, k, v, round_first=False):
    """The K4 tensor-core forward's arithmetic on bf16 numpy (B, T, H, D)
    self-attention inputs: (out bf16, lse (B*H, T) f32).  round_first rounds
    exp(s - m) to bf16 and divides by l after p @ v instead."""
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    B, H, T, D = qh.shape
    scale_log2 = float(np.float32(D**-0.5) * np.float32(LOG2E))
    out, lse = torch.empty_like(qh), torch.empty((B, H, T))
    for r0 in range(0, T, WARP_ROWS):
        rows = torch.arange(r0, min(r0 + WARP_ROWS, T))
        m = torch.full((B, H, len(rows)), float("-inf"))
        l = torch.zeros_like(m)
        for key0 in range(0, T, TILE_KEYS):  # pass 1: the row statistics
            s = _scores(qh[..., rows, :], kh, key0, scale_log2, T, rows, False)
            m_new = torch.maximum(m, s.amax(-1))
            l = l * torch.exp2(m - m_new) + torch.exp2(s - m_new[..., None]).sum(-1)
            m = m_new
        inv_l = 1.0 / l
        acc = torch.zeros((B, H, len(rows), D))
        for key0 in range(0, T, TILE_KEYS):  # pass 2: p @ v
            s = _scores(qh[..., rows, :], kh, key0, scale_log2, T, rows, False)
            e = torch.exp2(s - m[..., None])
            vt = vh[..., key0: key0 + TILE_KEYS, :]
            if round_first:
                acc = acc + e.bfloat16().float() @ vt
            else:
                acc = acc + (e * inv_l[..., None]).bfloat16().float() @ vt
        out[..., rows, :] = acc * inv_l[..., None] if round_first else acc
        lse[..., rows] = (m + torch.log2(l)) * LN2
    return out.bfloat16().transpose(1, 2), lse.reshape(B * H, T)


def _differing(got, ref):
    return float((got.float().numpy() != np.asarray(ref, np.float32)).mean())


def _jax_k5(q, k, v, causal):
    with pltpu.force_tpu_interpret_mode():
        return j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=causal)


# (B, Tq, Tkv, H, D, causal): the serve widths' head dims, a ragged T, Tq !=
# Tkv, causal self-attention and top-left causal with Tq != Tkv both ways;
# head dim 8 (the block zoo's: one 16-deep k-step over 8 zero-padded
# columns) at a zoo shape and causal with Tq != Tkv
K5_CASES = [(1, 200, 200, 2, 32, False), (2, 64, 64, 2, 64, False), (1, 100, 260, 2, 48, False),
            (1, 96, 96, 2, 32, True), (1, 70, 200, 2, 64, True), (1, 200, 70, 2, 48, True),
            (1, 56, 56, 48, 8, False), (2, 70, 130, 2, 8, True)]


@pytest.mark.parametrize("case", K5_CASES, ids=lambda c: "B{}-Tq{}-Tkv{}-H{}-D{}-causal{}".format(*c))
def test_k5_model_matches_the_pallas_kernel_bf16(rng, case):
    B, Tq, Tkv, H, D, causal = case
    q, k, v = _bf16(rng, B, Tq, H, D), _bf16(rng, B, Tkv, H, D), _bf16(rng, B, Tkv, H, D)
    ref = _jax_k5(q, k, v, causal)
    got = k5_model(q, k, v, causal)
    assert bool(torch.isfinite(got.float()).all())
    assert _differing(got, ref) <= 0.02
    scale = np.abs(np.asarray(ref, np.float32)).max()
    assert np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max() <= 1e-2 * scale


def test_k5_bf16_p_variant_fails_the_bound(rng):
    """Rounding p to bf16 (K4's and the plain attention's habit) changes far
    more than 2% of K5's outputs: the bound sees the hi/lo split."""
    q, k, v = (_bf16(rng, 1, 200, 2, 32) for _ in range(3))
    ref = _jax_k5(q, k, v, False)
    assert _differing(k5_model(q, k, v), ref) <= 0.02
    assert _differing(k5_model(q, k, v, p_bf16=True), ref) >= 0.20


@pytest.mark.parametrize("T,D", [(56, 64), (130, 32), (200, 48), (56, 8), (130, 8)])
def test_k4_model_matches_the_pallas_kernel_bf16(rng, T, D):
    """Outputs and LSE both from the JAX forward (the custom_vjp's
    `_fused_fwd`, whose residuals hold the LSE rows the backward reads)."""
    q, k, v = (_bf16(rng, 1, T, 2, D) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref, res = j_fused_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 16)
    ref_lse = torch.from_numpy(np.asarray(res[4])[:, :T].copy())  # (B*H, Tp) -> (B*H, T)
    got, lse = k4_model(q, k, v)
    assert _differing(got, ref) <= 0.02
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def test_k4_round_before_normalising_fails_the_bound(rng):
    """Rounding exp(s - m) to bf16 and dividing by l after p @ v changes far
    more than 2% of K4's outputs: the bound sees where K4 rounds."""
    q, k, v = (_bf16(rng, 1, 130, 2, 32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert _differing(k4_model(q, k, v)[0], ref) <= 0.02
    assert _differing(k4_model(q, k, v, round_first=True)[0], ref) >= 0.20


def test_online_update_gives_fully_masked_rows_no_weight():
    """In one 16-row tile some rows have every key masked (a first tile:
    m = -inf) while others do not: the masked rows stay at m = -inf, p = 0,
    l = 0, acc = 0 with no NaN, and the others take the plain softmax step."""
    s = torch.randn((1, 1, WARP_ROWS, TILE_KEYS))
    s[..., 3, :] = float("-inf")
    s[..., 9, :] = float("-inf")
    m = torch.full((1, 1, WARP_ROWS), float("-inf"))
    m, p, l, acc = online_update(s, m, torch.zeros_like(m), torch.zeros((1, 1, WARP_ROWS, 8)))
    for x in (p, l, acc):
        assert not bool(torch.isnan(x).any())
    assert bool((p[..., [3, 9], :] == 0).all()) and bool((l[..., [3, 9]] == 0).all())
    assert bool((m[..., [3, 9]] == float("-inf")).all())
    live = [i for i in range(WARP_ROWS) if i not in (3, 9)]
    torch.testing.assert_close(p[..., live, :] / l[..., live, None], torch.softmax(s[..., live, :] / LOG2E, -1),
                               atol=1e-6, rtol=1e-5)
    # a later tile with keys for those rows: alpha = exp2(-inf - m) = 0 keeps them clean
    s2 = torch.randn((1, 1, WARP_ROWS, TILE_KEYS))
    m2, p2, l2, _ = online_update(s2, m, l, acc)
    assert bool(torch.isfinite(m2).all()) and bool(torch.isfinite(l2).all())
    torch.testing.assert_close(l2[..., [3, 9]], p2[..., [3, 9], :].sum(-1))


# ---- the wrappers' launch plan, on CPU tensors

WRAPPERS = [(k5, "flash_attention"), (k4, "attention_fwd")]


def _fused_views(dtype, T=24, D=32, H=8):
    """q, k, v as views of one fused projection, v through a transpose."""
    qkv = torch.zeros((2, T, 3 * H * D), dtype=dtype)
    q, k, _ = (x.reshape(2, T, H, D) for x in qkv.chunk(3, dim=-1))
    v = torch.zeros((2, H, T, D), dtype=dtype).transpose(1, 2)
    return q, k, v


@pytest.mark.parametrize("mod,stem", WRAPPERS, ids=["k5", "k4"])
def test_plan_picks_the_entry_by_dtype_and_packs_the_strides(mod, stem):
    for dtype, suffix in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = _fused_views(dtype)
        name, strides = mod.plan(q, k, v)
        assert name == f"{stem}_{suffix}" and name in mod.ENTRIES.values()
        assert strides == q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
        assert strides == (24 * 768, 768, 32, 24 * 768, 768, 32, 8 * 24 * 32, 32, 24 * 32)
    assert mod.SIMT_BF16 == f"{stem}_simt_bf16" and mod.SIMT_BF16 not in mod.ENTRIES.values()


_STRIDE_NAMES = ("sqb", "sqt", "sqh", "skb", "skt", "skh", "svb", "svt", "svh")


def test_launch_args_pack_the_c_structs():
    """The one argument of the C entries: the `Args` structs of
    csrc/flash_attention.cu and csrc/attention_fwd.cu (144 bytes each:
    pointers and strides, then the ints and the scale), each value under
    the name `ARG_NAMES` gives its field."""
    q, k, v = _fused_views(torch.bfloat16, T=24, D=32)
    out = torch.empty((2, 24, 8, 32), dtype=torch.bfloat16)
    _, strides = k5.plan(q, k, v)
    packed = k5.launch_args(q, k, v, out, strides, True, 0.25, 12345)
    assert len(packed) == k5.ARGS.size == 144
    assert dict(zip(k5.ARG_NAMES, k5.ARGS.unpack(packed), strict=True)) == dict(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), out=out.data_ptr(), stream=12345,
        **dict(zip(_STRIDE_NAMES, strides)), B=2, Tq=24, Tkv=24, H=8, D=32, causal=1, scale=0.25)
    assert k5.ARGS.unpack(k5.launch_args(q, k, v, out, strides, False, None, 0))[-2:] == (0, pytest.approx(32**-0.5))
    lse = torch.empty((16, 24))
    _, strides = k4.plan(q, k, v)
    packed = k4.launch_args(q, k, v, out, lse, strides, None, 777)
    assert len(packed) == k4.ARGS.size == 144
    assert dict(zip(k4.ARG_NAMES, k4.ARGS.unpack(packed), strict=True)) == dict(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), out=out.data_ptr(), lse=lse.data_ptr(), stream=777,
        **dict(zip(_STRIDE_NAMES, strides)), B=2, T=24, H=8, D=32, scale=pytest.approx(32**-0.5))


def _struct_offsets(fmt: str) -> list:
    """The byte offset of each value a little-endian struct format packs."""
    offsets, at = [], 0
    for count, code in re.findall(r"(\d*)([a-zA-Z])", fmt.lstrip("<")):
        n = int(count or 1)
        if code == "x":  # padding
            at += n
            continue
        for _ in range(n):
            offsets.append(at)
            at += struct.calcsize("<" + code)
    return offsets


@pytest.mark.parametrize("mod,source", [(k5, "flash_attention.cu"), (k4, "attention_fwd.cu")], ids=["k5", "k4"])
def test_args_fields_sit_where_the_c_struct_asserts_them(mod, source):
    """Each C `Args` asserts every field's offset (static_assert, checked
    when nvcc builds it); here those offsets are held to the wrapper's
    format and field names, so a swapped pair of fields fails on the CPU."""
    text = (build.CSRC_DIR / source).read_text()
    c_offsets = {name: int(at) for name, at in re.findall(r"^ARG_AT\((\w+), (\d+)\);", text, re.M)}
    assert c_offsets == dict(zip(mod.ARG_NAMES, _struct_offsets(mod.ARGS.format), strict=True))
    assert f"static_assert(sizeof(Args) == {mod.ARGS.size}," in text


@pytest.mark.parametrize("mod", [k5, k4], ids=["k5", "k4"])
@pytest.mark.parametrize("what", ["pointer", "stride"])
def test_plan_raises_on_a_misaligned_bf16_view(mod, what):
    """bf16: a data pointer off 16 bytes, or a row stride that is not a
    multiple of 8 elements, raises ValueError; f32 (the CUDA-core kernel,
    no 16-byte copies) takes the same views."""
    for dtype in (torch.bfloat16, torch.float32):
        width = 8 * 32 + (8 if what == "pointer" else 4)
        base = torch.zeros((1, 64, width), dtype=dtype)
        q = (base[..., 1:257] if what == "pointer" else base[..., :256]).view(1, 64, 8, 32)
        x = torch.zeros((1, 64, 8, 32), dtype=dtype)
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="16-byte"):
                mod.plan(q, x, x)
        else:
            mod.plan(q, x, x)


@pytest.mark.parametrize("mod", [k5, k4], ids=["k5", "k4"])
def test_plan_rejects_what_the_kernels_do_not_take(mod):
    x = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        mod.plan(*(torch.zeros((1, 8, 2, 16)),) * 3)
    with pytest.raises(TypeError):
        mod.plan(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros((1, 8, 32, 2), dtype=torch.bfloat16).transpose(2, 3)
        mod.plan(y, y, y)


class _FakeFn:
    """A C function stand-in that counts assignments of its argtypes."""

    def __init__(self):
        self.argtypes_sets = 0

    def __setattr__(self, name, value):
        if name == "argtypes":
            object.__setattr__(self, "argtypes_sets", self.argtypes_sets + 1)
        object.__setattr__(self, name, value)


class _FakeLib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _FakeFn())


def test_entry_sets_argtypes_once_per_library(monkeypatch):
    libs = [_FakeLib(), _FakeLib()]
    current = [libs[0]]
    monkeypatch.setattr(build, "load_library", lambda: current[0])
    monkeypatch.setattr(build, "_entries", {})
    for mod in (k5, k4):
        name = next(iter(mod.ENTRIES.values()))
        fns = [build.entry(name, build.PACKED_ARGTYPES) for _ in range(3)]
        assert fns[0] is fns[1] is fns[2] is libs[0].fns[name]
        assert fns[0].argtypes_sets == 1 and fns[0].argtypes == [ctypes.c_char_p]
        assert fns[0].restype is ctypes.c_int
    current[0] = libs[1]  # a rebuilt library: set once more, on its own function
    fn = build.entry(k5.ENTRIES[torch.bfloat16], build.PACKED_ARGTYPES)
    assert fn is libs[1].fns[k5.ENTRIES[torch.bfloat16]] and fn.argtypes_sets == 1
    assert libs[0].fns[k5.ENTRIES[torch.bfloat16]].argtypes_sets == 1


def test_launch_packed_passes_the_struct_and_raises_on_a_cuda_error(monkeypatch):
    """`build.launch_packed` calls the entry with `pack(stream)` for the
    current stream of the tensor's device, switching devices only when that
    is not the current one, and raises on a nonzero cudaError."""
    calls, switched = [], []

    class _Stream:
        def __init__(self, index):
            self.cuda_stream = 1000 + index

    class _Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            switched.append(self.index)
            monkeypatch.setattr(torch.cuda, "current_device", lambda: self.index)

        def __exit__(self, *exc):
            monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(build, "entry", lambda name, argtypes: lambda packed: calls.append((name, packed)) or 0)
    build.launch_packed("flash_attention_bf16", 0, lambda stream: b"s%d" % stream)
    build.launch_packed("attention_fwd_bf16", 1, lambda stream: b"s%d" % stream)
    assert calls == [("flash_attention_bf16", b"s1000"), ("attention_fwd_bf16", b"s1001")] and switched == [1]
    monkeypatch.setattr(build, "entry", lambda name, argtypes: lambda packed: 700)
    with pytest.raises(RuntimeError, match="attention_fwd_bf16 launch failed: cudaError 700"):
        build.launch_packed("attention_fwd_bf16", 0, lambda stream: b"")
