"""K2 + K3: one whole UNet-1D denoiser forward at B=1 as one kernel launch.

Counterpart of `latent_diffusion_speech_tpu/ops/pallas/unet1d_fused.py`
(`unet_fwd_pallas`, K2) and `ops/pallas/unet1d_stream.py`
(`unet_fwd_pallas_stream`, K3): both compute the same function, one
flagship UNet-1D forward at B=1, and one Hopper kernel (`csrc/unet_fwd.cu`)
serves both.  The TPU layout work (the VMEM segment planner, the 128-lane
head-padding permutation matmuls, the iota selection matmuls for resampling,
K3's lane-class row chunking) has no counterpart here: the kernel reads the
weights in place and resamples by indexing.

* `build_unet_plan(cfg)` is the static op list (`_Res`, `_Attn`, `_Conv`
  with modes plain/down/up, `_Final`, `_Push`, `_Pop`), op for op the JAX
  package's.
* `pack_unet_params(unet, cfg)` lays the port's `UNet1D` out once for the
  kernel: one flat weight buffer in the compute dtype (k=3 conv kernels as
  (3, cin, cout), matrices as (in, out), q/k/v side by side as (C, 3C)), one
  f32 buffer of norm scales/biases and biases, and the fused time
  projection (every res block's `time_emb_proj` in one matrix).
* `unet_fwd_plain(packed, x, t, cfg)` is the plain PyTorch version: it reads
  the packed buffers and rounds to the compute dtype where K2 rounds (after
  every matrix product, after every GroupNorm/LayerNorm, after each
  elementwise step of the time scale/shift, SiLU and GEGLU).
* `unet_fwd(packed, x, t, cfg)` launches the kernel for CUDA tensors and
  runs `unet_fwd_plain` for CPU tensors; any other device raises.  The
  kernel walks an int32 table of phases (`_table`) built per frame count T;
  the time MLP and the fused time projection run before it as three
  `torch.nn.functional.linear` calls, as the JAX package runs them in XLA
  outside its Pallas call.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import timestep_embedding
from latent_diffusion_speech_tpu_torch.ops.kernels.fused_attention import (
    SUPPORTED_HEAD_DIMS,
    fused_attention_plain,
)
from latent_diffusion_speech_tpu_torch.utils import profiler

__all__ = [
    "build_unet_plan",
    "pack_unet_params",
    "PackedUNet",
    "unet_fwd",
    "unet_fwd_plain",
    "unet_flops",
    "FIELDS",
]

_DTYPES = {torch.bfloat16: "unet_fwd_bf16", torch.float32: "unet_fwd_f32"}
ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3)

# kernel launches since the last reset (chip_smoke.py resets and reads it)
launches = 0


# ---------------------------------------------------------------------------
# plan: the static op list (mirror of unet1d_fused.py::build_unet_plan)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Res:
    cin: int
    cout: int
    groups: int
    ss_row: int          # index of this res block (its scale/shift rows)
    name: str


@dataclass(frozen=True)
class _Attn:
    c: int
    heads: int
    groups: int
    name: str


@dataclass(frozen=True)
class _Conv:
    cin: int
    cout: int
    mode: str            # "plain" | "down" | "up"
    name: str


@dataclass(frozen=True)
class _Final:
    c: int
    cout: int
    groups: int


@dataclass(frozen=True)
class _Push:
    idx: int
    ch: int
    tdiv: int


@dataclass(frozen=True)
class _Pop:
    idx: int
    ch: int
    tdiv: int


def build_unet_plan(cfg) -> Tuple[list, int]:
    """Static op list mirroring `UNet1D.forward`, plus the number of res
    blocks."""
    boc = cfg.block_out_channels
    n = len(boc)
    lpb = cfg.layers_per_block
    g = cfg.norm_num_groups
    ops: list = []
    n_res = 0
    skip_idx = 0
    stack: List[Tuple[int, int, int]] = []
    tdiv = 1

    def res(cin, cout, name):
        nonlocal n_res
        ops.append(_Res(cin, cout, g, n_res, name))
        n_res += 1

    def push(ch):
        nonlocal skip_idx
        ops.append(_Push(skip_idx, ch, tdiv))
        stack.append((skip_idx, ch, tdiv))
        skip_idx += 1

    ops.append(_Conv(cfg.in_channels, boc[0], "plain", "conv_in"))
    ch = boc[0]
    push(ch)
    for i in range(n):
        for j in range(lpb):
            res(ch, boc[i], f"down_{i}_res_{j}")
            ch = boc[i]
            if cfg.cross_attn[i]:
                ops.append(_Attn(boc[i], cfg.n_heads, g, f"down_{i}_attn_{j}"))
            push(ch)
        if i < n - 1:
            ops.append(_Conv(boc[i], boc[i], "down", f"down_{i}_downsample"))
            tdiv *= 2
            push(ch)

    res(ch, boc[-1], "mid_res_0")
    ops.append(_Attn(boc[-1], cfg.n_heads, g, "mid_attn"))
    res(boc[-1], boc[-1], "mid_res_1")
    ch = boc[-1]

    rev = list(reversed(boc))
    rev_attn = list(reversed(cfg.cross_attn))
    for i in range(n):
        for j in range(lpb + 1):
            sidx, sch, stdiv = stack.pop()
            assert stdiv == tdiv, "skip/resolution mismatch in plan"
            ops.append(_Pop(sidx, sch, stdiv))
            res(ch + sch, rev[i], f"up_{i}_res_{j}")
            ch = rev[i]
            if rev_attn[i]:
                ops.append(_Attn(rev[i], cfg.n_heads, g, f"up_{i}_attn_{j}"))
        if i < n - 1:
            ops.append(_Conv(rev[i], rev[i], "up", f"up_{i}_upsample"))
            tdiv //= 2

    ops.append(_Final(ch, cfg.out_channels, g))
    return ops, n_res


# ---------------------------------------------------------------------------
# packing: the port's UNet1D -> one weight buffer, one f32 buffer
# ---------------------------------------------------------------------------

@dataclass
class PackedUNet:
    """The kernel's layout of one `UNet1D`.

    `layout[i]` maps the names of plan op i's tensors to (buffer, offset,
    shape), buffer "w" (`weights`, compute dtype) or "p" (`params`, f32);
    `sources` lists the module parameter names in the order they were packed
    (the test checks that each is packed once)."""

    cfg: object
    ops: list
    dtype: torch.dtype
    device: torch.device
    weights: torch.Tensor
    params: torch.Tensor
    layout: List[Dict[str, Tuple[str, int, tuple]]]
    time: Dict[str, torch.Tensor]
    ss_off: List[int]                 # per res block: offset of its scale in the ss row
    sources: List[str]
    _tables: dict = field(default_factory=dict)

    def get(self, i: int, name: str) -> torch.Tensor:
        buf, off, shape = self.layout[i][name]
        flat = self.weights if buf == "w" else self.params
        n = 1
        for s in shape:
            n *= s
        return flat[off: off + n].view(shape)


def pack_unet_params(unet, cfg=None) -> PackedUNet:
    """Lay a `UNet1D`'s weights out for the kernel (runs once per sampling
    call, before the sampler loop)."""
    cfg = cfg if cfg is not None else unet.cfg
    ops, _ = build_unet_plan(cfg)
    params = dict(unet.named_parameters())
    ref = unet.conv_in.weight
    dtype, device = ref.dtype, ref.device
    wparts: List[torch.Tensor] = []
    pparts: List[torch.Tensor] = []
    sizes = {"w": 0, "p": 0}
    layout: List[Dict[str, Tuple[str, int, tuple]]] = []
    sources: List[str] = []

    def put(entry, key, buf, tensor, names):
        tensor = tensor.detach()
        parts = wparts if buf == "w" else pparts
        parts.append(tensor.to(dtype if buf == "w" else torch.float32).reshape(-1))
        entry[key] = (buf, sizes[buf], tuple(tensor.shape))
        sizes[buf] += tensor.numel()
        if buf == "w" and sizes[buf] % _ALIGN:
            # every matrix starts on a multiple of 8 elements (vector loads)
            pad = _ALIGN - sizes[buf] % _ALIGN
            parts.append(torch.zeros(pad, dtype=dtype, device=device))
            sizes[buf] += pad
        sources.extend(names)

    def conv3(entry, key, prefix):      # Conv1d (out, in, 3) -> (3, in, out)
        put(entry, key, "w", params[prefix + ".weight"].permute(2, 1, 0), [prefix + ".weight"])

    def dense(entry, key, prefix):      # Linear (out, in) -> (in, out)
        put(entry, key, "w", params[prefix + ".weight"].t(), [prefix + ".weight"])

    def vec(entry, key, name):
        put(entry, key, "p", params[name], [name])

    for op in ops:
        e: Dict[str, Tuple[str, int, tuple]] = {}
        if isinstance(op, _Res):
            p = op.name
            conv3(e, "conv1", p + ".conv1")
            conv3(e, "conv2", p + ".conv2")
            if op.cin != op.cout:
                put(e, "shortcut", "w", params[p + ".conv_shortcut.weight"][:, :, 0].t(),
                    [p + ".conv_shortcut.weight"])
                vec(e, "b_sc", p + ".conv_shortcut.bias")
            for key, name in (("n1_g", "norm1.weight"), ("n1_b", "norm1.bias"),
                              ("n2_g", "norm2.weight"), ("n2_b", "norm2.bias"),
                              ("b1", "conv1.bias"), ("b2", "conv2.bias")):
                vec(e, key, f"{p}.{name}")
        elif isinstance(op, _Attn):
            p = op.name
            dense(e, "proj_in", p + ".proj_in")
            for a in ("attn1", "attn2"):
                qkv = [f"{p}.{a}.to_{x}.weight" for x in "qkv"]
                put(e, "qkv" + a[-1], "w", torch.cat([params[n] for n in qkv]).t(), qkv)
                dense(e, "o" + a[-1], f"{p}.{a}.to_out")
            dense(e, "ff_proj", p + ".ff_proj")
            dense(e, "ff_out", p + ".ff_out")
            dense(e, "proj_out", p + ".proj_out")
            for key, name in (("gn_g", "norm.weight"), ("gn_b", "norm.bias"),
                              ("ln1_g", "norm1.weight"), ("ln1_b", "norm1.bias"),
                              ("ln2_g", "norm2.weight"), ("ln2_b", "norm2.bias"),
                              ("ln3_g", "norm3.weight"), ("ln3_b", "norm3.bias"),
                              ("b_pi", "proj_in.bias"), ("b_o1", "attn1.to_out.bias"),
                              ("b_o2", "attn2.to_out.bias"), ("b_ffp", "ff_proj.bias"),
                              ("b_ffo", "ff_out.bias"), ("b_po", "proj_out.bias")):
                vec(e, key, f"{p}.{name}")
        elif isinstance(op, _Conv):
            p = op.name if op.name == "conv_in" else op.name + ".conv"
            conv3(e, "w", p)
            vec(e, "b", p + ".bias")
        elif isinstance(op, _Final):
            conv3(e, "w", "conv_out")
            vec(e, "gn_g", "conv_norm_out.weight")
            vec(e, "gn_b", "conv_norm_out.bias")
            vec(e, "b", "conv_out.bias")
        layout.append(e)

    # fused time projection: every res block's time_emb_proj in one matrix;
    # block r's scale sits at ss_off[r], its shift at ss_off[r] + cout
    res_ops = [op for op in ops if isinstance(op, _Res)]
    proj = [getattr(unet, op.name).time_emb_proj for op in res_ops]
    ss_off, off = [], 0
    for op in res_ops:
        ss_off.append(off)
        off += 2 * op.cout
    for op in res_ops:
        sources += [f"{op.name}.time_emb_proj.weight", f"{op.name}.time_emb_proj.bias"]
    time = {
        "mlp1_w": unet.time_mlp1.weight, "mlp1_b": unet.time_mlp1.bias,
        "mlp2_w": unet.time_mlp2.weight, "mlp2_b": unet.time_mlp2.bias,
        "proj_w": torch.cat([m.weight for m in proj]).to(dtype),
        "proj_b": torch.cat([m.bias for m in proj]).to(dtype),
    }
    return PackedUNet(
        cfg=cfg, ops=ops, dtype=dtype, device=device,
        weights=torch.cat(wparts).contiguous(), params=torch.cat(pparts).contiguous(),
        layout=layout, time=time, ss_off=ss_off, sources=sources,
    )


def _scale_shift(packed: PackedUNet, t: torch.Tensor) -> torch.Tensor:
    """Time MLP + the fused time projection -> (sum of 2*cout,) in the
    compute dtype (the scale and shift rows of every res block)."""
    tm = packed.time
    temb = timestep_embedding(t.reshape(-1)[:1], packed.cfg.block_out_channels[0]).to(packed.dtype)
    temb = F.linear(temb, tm["mlp1_w"], tm["mlp1_b"])
    temb = F.linear(F.silu(temb), tm["mlp2_w"], tm["mlp2_b"])
    return F.linear(F.silu(temb), tm["proj_w"], tm["proj_b"])[0].contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch version (f32 arithmetic, rounded where K2 rounds)
# ---------------------------------------------------------------------------

def _group_norm(x, gamma, beta, groups, eps):
    """x (T, C) f32 -> GroupNorm over (T, C/groups) per group, with the
    kernel's (and K2's) statistics: var = E[x^2] - E[x]^2 from per-channel
    sums."""
    T, C = x.shape
    xg = x.reshape(T, groups, C // groups)
    mean = xg.sum(dim=0).sum(dim=-1)[None, :, None] / (T * (C // groups))
    sq = (xg * xg).sum(dim=0).sum(dim=-1)[None, :, None] / (T * (C // groups))
    var = (sq - mean * mean).clamp_min(0.0)
    y = (xg - mean) * torch.rsqrt(var + eps)
    return y.reshape(T, C) * gamma + beta


def _layer_norm(x, gamma, beta, eps):
    """LayerNorm over the last axis with the kernel's (and K2's) statistics:
    var = E[x^2] - E[x]^2 from per-row sums."""
    C = x.shape[-1]
    mean = x.sum(dim=-1, keepdim=True) / C
    var = ((x * x).sum(dim=-1, keepdim=True) / C - mean * mean).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def _conv3(x, w, mode="plain"):
    """k=3 'same' conv of x (T, Cin) f32 with w (3, Cin, Cout); 'down' keeps
    the even output rows (stride 2), 'up' repeats each input row first."""
    if mode == "up":
        x = x.repeat_interleave(2, dim=0)
    z = F.pad(x, (0, 0, 1, 1))
    w = w.float()
    y = z[:-2] @ w[0] + z[1:-1] @ w[1] + z[2:] @ w[2]
    return y[0::2] if mode == "down" else y


def unet_fwd_plain(packed: PackedUNet, x: torch.Tensor, t: torch.Tensor, cfg=None) -> torch.Tensor:
    """x (1, T, in_channels), t (1,) -> eps (1, T, out_channels), computed
    from the packed buffers in f32 and rounded to the compute dtype at K2's
    places (a no-op in f32)."""
    _check_cfg(packed, cfg)
    dtype = packed.dtype

    def r(v):
        return v.to(dtype).float()

    def silu(v):
        return r(F.silu(v))

    ss = _scale_shift(packed, t).float()
    h = r(x[0].float())
    skips: Dict[int, torch.Tensor] = {}
    for i, op in enumerate(packed.ops):
        g = lambda name: packed.get(i, name)  # noqa: E731
        if isinstance(op, _Res):
            y = silu(r(_group_norm(h, g("n1_g"), g("n1_b"), op.groups, 1e-5)))
            y = r(_conv3(y, g("conv1")) + g("b1"))
            off = packed.ss_off[op.ss_row]
            scale, shift = ss[off: off + op.cout], ss[off + op.cout: off + 2 * op.cout]
            y = r(_group_norm(y, g("n2_g"), g("n2_b"), op.groups, 1e-5))
            y = silu(r(r(y * r(1 + scale)) + shift))
            y = r(_conv3(y, g("conv2")) + g("b2"))
            if op.cin != op.cout:
                h = r(h @ g("shortcut").float() + g("b_sc"))
            h = r(h + y)
        elif isinstance(op, _Attn):
            residual = h
            c, T = op.c, h.shape[0]
            y = r(_group_norm(h, g("gn_g"), g("gn_b"), op.groups, 1e-6))
            y = r(y @ g("proj_in").float() + g("b_pi"))
            for a in "12":
                ln = r(_layer_norm(y, g(f"ln{a}_g"), g(f"ln{a}_b"), 1e-6))
                qkv = r(ln @ g("qkv" + a).float()).to(dtype)
                q, k, v = (z.reshape(1, T, op.heads, c // op.heads) for z in qkv.split(c, dim=-1))
                o = fused_attention_plain(q, k, v)[0].float().reshape(T, c)
                y = r(y + r(o @ g("o" + a).float() + g("b_o" + a)))
            ln = r(_layer_norm(y, g("ln3_g"), g("ln3_b"), 1e-6))
            gate = r(ln @ g("ff_proj").float() + g("b_ffp"))
            u = r(gate[:, : 4 * c] * r(F.gelu(gate[:, 4 * c:])))
            y = r(y + r(u @ g("ff_out").float() + g("b_ffo")))
            y = r(y @ g("proj_out").float() + g("b_po"))
            h = r(y + residual)
        elif isinstance(op, _Conv):
            h = r(_conv3(h, g("w"), op.mode) + g("b"))
        elif isinstance(op, _Final):
            y = silu(r(_group_norm(h, g("gn_g"), g("gn_b"), op.groups, 1e-5)))
            h = r(_conv3(y, g("w")) + g("b"))
        elif isinstance(op, _Push):
            skips[op.idx] = h
        elif isinstance(op, _Pop):
            h = torch.cat([h, skips.pop(op.idx)], dim=-1)
    return h.to(dtype)[None]


# ---------------------------------------------------------------------------
# the kernel's phase table
# ---------------------------------------------------------------------------

# Fields of one int32 record of the table, in the order of the enum in
# csrc/unet_fwd.cu (a CPU test holds the two lists equal).
FIELDS = (
    "KIND", "A_BUF", "A_OFF", "A_LD", "A_C", "B_BUF", "B_OFF", "B_LD", "B_C",
    "T_IN", "T_OUT", "MODE", "TAPS", "N", "W_OFF", "BIAS_OFF", "PRO", "SILU", "SS_OFF",
    "GAMMA_OFF", "BETA_OFF", "CST_A", "CST_B", "GROUPS", "OUT_BUF", "OUT_OFF", "OUT_LD",
    "RES_BUF", "RES_OFF", "RES_LD", "EPS", "SYNC", "ACC", "CST_OUT", "RST_A", "RST_OUT",
)
REC = 40
_F = {name: i for i, name in enumerate(FIELDS)}
KIND_GEMM, KIND_ATTN = 1, 2
PRO_NONE, PRO_GN, PRO_LN, PRO_GEGLU = 0, 1, 2, 3
MODES = {"plain": 0, "down": 1, "up": 2}
BUF_WS, BUF_X, BUF_Y = 0, 1, 2
_ALIGN = 8  # elements: 16-byte aligned activations in bf16
MAX_NORM_C = 1024  # channels of a GroupNorm / LayerNorm input, at most (MAX_NORM_C in the kernel)


@dataclass(frozen=True)
class _View:
    buf: int
    off: int
    ld: int
    c: int
    cst: int = -1   # offset of its per-channel [sums | sums of squares], f32
    rst: int = -1   # offset of its per-row [sums | sums of squares], f32


@dataclass
class _Table:
    records: torch.Tensor          # (n, REC) int32, on the packed device
    ws_elems: int                  # activation workspace, compute dtype
    stats_elems: int               # per-channel sums of GroupNorm inputs, f32
    phases: int                    # grid barriers
    cnt_elems: int                 # one split-K counter region: the most GEMM tiles
    flops: int                     # matrix products + attention, this T


def _f32_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


def _build_table(packed: PackedUNet, T: int) -> _Table:
    """Phase table of one forward at frame count T: every res block is
    conv1 (+ the 1x1 shortcut in the same phase) -> conv2 with the residual;
    every transformer block is proj_in -> (q/k/v -> attention -> out +
    residual) x 2 -> GEGLU in -> GEGLU out + residual -> proj_out +
    residual.  A GroupNorm or LayerNorm reads the sums its input's producer
    accumulated (`alloc(normed=...)`), so it needs no phase of its own."""
    recs: List[List[int]] = []
    acc = {"tiles": 1, "in_phase": 0}
    ws = [0]
    stats = [0]
    flops = [0]

    def alloc(rows, cols, normed=False, row_normed=False):
        """An activation; one read through a GroupNorm (`normed`) or a
        LayerNorm (`row_normed`) also gets the per-channel or per-row sums
        its producer accumulates."""
        off = ws[0]
        ws[0] += (rows * cols + _ALIGN - 1) // _ALIGN * _ALIGN
        cst = rst = -1
        if normed:
            cst = stats[0]
            stats[0] += 2 * cols
        if row_normed:
            rst = stats[0]
            stats[0] += 2 * rows
        return _View(BUF_WS, off, cols, cols, cst, rst)

    def w_off(i, name):
        buf, off, _ = packed.layout[i][name]
        assert buf == "w"
        return off

    def p_off(i, name):
        buf, off, _ = packed.layout[i][name]
        assert buf == "p"
        return off

    def rec(kind, sync=True, **kw):
        r = [0] * REC
        r[_F["KIND"]] = kind
        r[_F["CST_OUT"]] = r[_F["RST_OUT"]] = -1
        r[_F["SYNC"]] = int(sync)
        for k, v in kw.items():
            r[_F[k.upper()]] = int(v)
        if kind == KIND_GEMM:
            # GEMMs of one phase take separate split-K regions
            r[_F["ACC"]] = acc["in_phase"]
            acc["in_phase"] += 1
            assert acc["in_phase"] <= 2
        if sync:
            acc["in_phase"] = 0
        recs.append(r)

    def src_fields(src):
        a = src[0]
        b = src[1] if len(src) > 1 else _View(BUF_WS, 0, 0, 0)
        return dict(a_buf=a.buf, a_off=a.off, a_ld=a.ld, a_c=a.c,
                    b_buf=b.buf, b_off=b.off, b_ld=b.ld, b_c=b.c)

    def gemm(src, rows, out, n, w, taps=1, mode="plain", bias=-1, pro=PRO_NONE, silu=0,
             ss_off=-1, gamma=0, beta=0, groups=1, eps=0.0, res=None, sync=True):
        cin = sum(v.c for v in src)
        t_out = rows // 2 if mode == "down" else rows * 2 if mode == "up" else rows
        rf = dict(res_buf=res.buf, res_off=res.off, res_ld=res.ld) if res is not None else dict(res_off=-1)
        if pro == PRO_GN:
            assert all(v.cst >= 0 for v in src) and groups <= 32
            rf.update(cst_a=src[0].cst, cst_b=src[-1].cst)
        if pro == PRO_LN:
            assert len(src) == 1 and src[0].rst >= 0 and taps == 1
            rf.update(rst_a=src[0].rst)
        rec(KIND_GEMM, sync=sync, t_in=rows, t_out=t_out, mode=MODES[mode], taps=taps, n=n, w_off=w,
            bias_off=bias, pro=pro, silu=silu, ss_off=ss_off, gamma_off=gamma, beta_off=beta,
            groups=groups, eps=_f32_bits(eps), cst_out=out.cst, rst_out=out.rst,
            out_buf=out.buf, out_off=out.off, out_ld=out.ld, **rf, **src_fields(src))
        flops[0] += 2 * t_out * n * taps * cin
        acc["tiles"] = max(acc["tiles"], -(-t_out // 64) * -(-n // 64))

    h = [_View(BUF_X, 0, packed.cfg.in_channels, packed.cfg.in_channels)]
    rows = T
    skips: Dict[int, _View] = {}
    for i, op in enumerate(packed.ops):
        if isinstance(op, _Res):
            y = alloc(rows, op.cout, normed=True)
            gemm(h, rows, y, op.cout, w_off(i, "conv1"), taps=3, bias=p_off(i, "b1"), pro=PRO_GN, silu=1,
                 gamma=p_off(i, "n1_g"), beta=p_off(i, "n1_b"), groups=op.groups, eps=1e-5,
                 sync=op.cin == op.cout)
            if op.cin != op.cout:
                res = alloc(rows, op.cout)
                gemm(h, rows, res, op.cout, w_off(i, "shortcut"), bias=p_off(i, "b_sc"))
            else:
                res = h[0]
            out = alloc(rows, op.cout, normed=True)
            gemm([y], rows, out, op.cout, w_off(i, "conv2"), taps=3, bias=p_off(i, "b2"), pro=PRO_GN,
                 silu=1, ss_off=packed.ss_off[op.ss_row], gamma=p_off(i, "n2_g"), beta=p_off(i, "n2_b"),
                 groups=op.groups, eps=1e-5, res=res)
            h = [out]
        elif isinstance(op, _Attn):
            c = op.c
            residual = h[0]
            y = alloc(rows, c, row_normed=True)
            gemm(h, rows, y, c, w_off(i, "proj_in"), bias=p_off(i, "b_pi"), pro=PRO_GN,
                 gamma=p_off(i, "gn_g"), beta=p_off(i, "gn_b"), groups=op.groups, eps=1e-6)
            for a in "12":
                qkv = alloc(rows, 3 * c)
                gemm([y], rows, qkv, 3 * c, w_off(i, "qkv" + a), pro=PRO_LN, gamma=p_off(i, f"ln{a}_g"),
                     beta=p_off(i, f"ln{a}_b"), eps=1e-6)
                att = alloc(rows, c)
                rec(KIND_ATTN, a_buf=qkv.buf, a_off=qkv.off, a_ld=qkv.ld, t_in=rows, n=c, groups=op.heads,
                    out_buf=att.buf, out_off=att.off, out_ld=att.ld, eps=_f32_bits((c // op.heads) ** -0.5))
                flops[0] += 4 * rows * rows * c
                y2 = alloc(rows, c, row_normed=True)
                gemm([att], rows, y2, c, w_off(i, "o" + a), bias=p_off(i, "b_o" + a), res=y)
                y = y2
            gate = alloc(rows, 8 * c)
            gemm([y], rows, gate, 8 * c, w_off(i, "ff_proj"), bias=p_off(i, "b_ffp"), pro=PRO_LN,
                 gamma=p_off(i, "ln3_g"), beta=p_off(i, "ln3_b"), eps=1e-6)
            y3 = alloc(rows, c)
            gemm([_View(gate.buf, gate.off, 8 * c, 4 * c)], rows, y3, c, w_off(i, "ff_out"),
                 bias=p_off(i, "b_ffo"), pro=PRO_GEGLU, res=y)
            out = alloc(rows, c, normed=True)
            gemm([y3], rows, out, c, w_off(i, "proj_out"), bias=p_off(i, "b_po"), res=residual)
            h = [out]
        elif isinstance(op, _Conv):
            t_out = rows // 2 if op.mode == "down" else rows * 2 if op.mode == "up" else rows
            out = alloc(t_out, op.cout, normed=True)
            gemm(h, rows, out, op.cout, w_off(i, "w"), taps=3, mode=op.mode, bias=p_off(i, "b"))
            h, rows = [out], t_out
        elif isinstance(op, _Final):
            gemm(h, rows, _View(BUF_Y, 0, op.cout, op.cout), op.cout, w_off(i, "w"), taps=3,
                 bias=p_off(i, "b"), pro=PRO_GN, silu=1, gamma=p_off(i, "gn_g"), beta=p_off(i, "gn_b"),
                 groups=op.groups, eps=1e-5)
        elif isinstance(op, _Push):
            assert len(h) == 1
            skips[op.idx] = h[0]
        elif isinstance(op, _Pop):
            h = [h[0], skips.pop(op.idx)]
    assert rows == T
    records = torch.tensor(recs, dtype=torch.int32).to(packed.device)
    return _Table(records=records, ws_elems=max(ws[0], 1), stats_elems=max(stats[0], 1),
                  phases=sum(r[_F["SYNC"]] for r in recs),
                  cnt_elems=acc["tiles"], flops=flops[0])


def _table(packed: PackedUNet, T: int) -> _Table:
    if T not in packed._tables:
        profiler.count("unet_fused.table_builds")
        with profiler.span("unet_fused.table_build"):
            packed._tables[T] = _build_table(packed, T)
    return packed._tables[T]


def unet_flops(packed: PackedUNet, T: int) -> int:
    """Operations of one forward at frame count T: 2 per multiply-add of
    every matrix product (convolution taps included) and 4*T*T*C per
    self-attention (q.k and p.v); the time MLP is left out."""
    return _table(packed, T).flops


def _check_cfg(packed: PackedUNet, cfg) -> None:
    if cfg is not None and cfg != packed.cfg:
        raise ValueError("cfg differs from the configuration the weights were packed with")


def _check(packed: PackedUNet, x: torch.Tensor) -> None:
    cfg = packed.cfg
    if x.dim() != 3 or x.shape[0] != 1 or x.shape[2] != cfg.in_channels:
        raise ValueError(f"unet_fwd takes x (1, T, {cfg.in_channels}), got {tuple(x.shape)}")
    if x.shape[1] % cfg.downsample_factor != 0:
        raise ValueError(f"T={x.shape[1]} is not a multiple of {cfg.downsample_factor}")
    if any(c % 8 for c in (cfg.in_channels, cfg.out_channels, *cfg.block_out_channels)):
        raise ValueError("the kernel loads 8 channels at a time: every channel count must be a multiple of 8")
    if 2 * max(cfg.block_out_channels) > MAX_NORM_C:
        raise ValueError(f"the kernel holds a normalised input's coefficients for at most {MAX_NORM_C} channels "
                         f"(an up block's concatenation has 2 x {max(cfg.block_out_channels)})")
    if packed.dtype not in _DTYPES:
        raise TypeError(f"unet_fwd takes bf16 or f32 weights, got {packed.dtype}")
    if x.device != packed.device:
        raise ValueError(f"x on {x.device}, weights on {packed.device}")
    for op in packed.ops:
        if isinstance(op, _Attn) and op.c // op.heads not in SUPPORTED_HEAD_DIMS:
            raise ValueError(f"head dim {op.c // op.heads} not in {SUPPORTED_HEAD_DIMS}")


def unet_fwd(packed: PackedUNet, x: torch.Tensor, t: torch.Tensor, cfg=None,
             phase_ns: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One denoiser forward, x (1, T, in_channels), t (1,) -> eps (1, T,
    out_channels) in x's dtype: the kernel (one launch) on CUDA, the plain
    version on CPU.

    phase_ns: optional int64 CUDA tensor of `_table(packed, T).phases + 1`
    elements; the kernel writes the GPU clock (ns) after each grid barrier."""
    global launches
    if x.device.type == "cpu":
        return unet_fwd_plain(packed, x, t, cfg).to(x.dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"unet_fwd: no kernel for device {x.device}")
    _check_cfg(packed, cfg)
    _check(packed, x)
    from latent_diffusion_speech_tpu_torch.ops.kernels.build import entry

    T = x.shape[1]
    table = _table(packed, T)
    dev = x.device
    ss = _scale_shift(packed, t)
    xin = x.to(packed.dtype).contiguous()
    ws = torch.empty(table.ws_elems, dtype=packed.dtype, device=dev)
    stats = torch.empty(table.stats_elems, dtype=torch.float32, device=dev)
    y = torch.empty((1, T, packed.cfg.out_channels), dtype=packed.dtype, device=dev)
    # split-K partial tiles: at most one 64 x 64 f32 tile per block of the
    # grid (SMs x at most 2 blocks, MAX_BLOCKS_PER_SM in csrc/unet_fwd.cu)
    acc_elems = torch.cuda.get_device_properties(dev).multi_processor_count * 2 * 64 * 64
    acc = torch.empty(2 * acc_elems, dtype=torch.float32, device=dev)
    cnt = torch.empty(2 * table.cnt_elems, dtype=torch.int32, device=dev)
    if phase_ns is not None and (phase_ns.dtype != torch.int64 or phase_ns.numel() < table.phases + 1
                                 or phase_ns.device != dev):
        raise ValueError(f"phase_ns must be an int64 tensor of {table.phases + 1} elements on {dev}")
    fn = entry(_DTYPES[packed.dtype], ARGTYPES)
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.records.data_ptr(), table.records.shape[0], packed.weights.data_ptr(),
                 packed.params.data_ptr(), ss.data_ptr(), ws.data_ptr(), xin.data_ptr(), y.data_ptr(),
                 stats.data_ptr(), table.stats_elems, acc.data_ptr(), acc_elems, cnt.data_ptr(),
                 table.cnt_elems, phase_ns.data_ptr() if phase_ns is not None else None, stream,
                 ctypes.cast(info, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"unet_fwd launch failed: cudaError {err}")
    launch_info.update(grid=info[0], blocks_per_sm=info[1])
    launches += 1
    return y.to(x.dtype)


# grid of the last launch: {'grid': blocks, 'blocks_per_sm': n}
launch_info: Dict[str, int] = {}
