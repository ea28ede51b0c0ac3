"""Plain PyTorch reference of the acoustic stage: units -> waveform.

The Unit2Mel condition, the denoiser UNet (one functional forward for both
layouts the benchmark runs: the flagship `UNet1D` and the reference-layout
`UNet1DCondition`, which compute the same graph under other parameter
names), multistep DPM-Solver++ of order 2 over the linear-beta schedule,
and the HiFi-VAEGAN generator.  It follows the published architecture
(the diffusers UNet blocks in 1-D, DPM-Solver++ as in `dpm_solver_pytorch`,
HiFi-GAN V1 stacks) and imports nothing of the program.

Every product computes in float32 with TF32 off.  `precision="fp8"` is the
control: every matrix product, convolution and attention product rounds
both of its operands to float8 e4m3 (one scale per tensor, its largest
magnitude at 448) before it multiplies in float32.

Weights are dicts keyed by the program's state-dict names (`spec` lists
them); the reference reads them through its own canonical names
(`canonical_names`), so the same tensors go to both sides.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


# ---------------------------------------------------------------------------
# products, in float32 or through float8 e4m3
# ---------------------------------------------------------------------------

class Products:
    """The products of one reference run, in `precision` ('f32' or 'fp8')."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {precision!r}")
        self.precision = precision

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return x
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1):
        """x (B, C, T) channels-first."""
        return F.conv1d(self.q(x), self.q(w), b, stride, padding, dilation)

    def conv_transpose(self, x, w, b, stride, padding):
        return F.conv_transpose1d(self.q(x), self.q(w), b, stride, padding)

    def attention(self, q, k, v):
        """q, k, v (B, T, H, D) -> (B, T, H, D), softmax(q k^T / sqrt(D)) v."""
        s = torch.einsum("bqhd,bkhd->bhqk", self.q(q), self.q(k)) * q.shape[-1] ** -0.5
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", self.q(p), self.q(v))


# ---------------------------------------------------------------------------
# the UNet's parameters: canonical names, the program's names, shapes
# ---------------------------------------------------------------------------

def _levels(cfg: dict):
    """(widths, number of levels, whether each level holds attention)."""
    boc = cfg["block_out_channels"]
    n = len(boc)
    attn = [i < n - 1 for i in range(n)]  # CrossAttnDown x (n-1) + Down
    return boc, n, attn


def _res_shapes(cin: int, cout: int, temb: int) -> List[Tuple[str, tuple, str]]:
    out = [("norm1.weight", (cin,), "norm_w"), ("norm1.bias", (cin,), "norm_b"),
           ("conv1.weight", (cout, cin, 3), "w"), ("conv1.bias", (cout,), "b"),
           ("time_emb_proj.weight", (2 * cout, temb), "w"), ("time_emb_proj.bias", (2 * cout,), "b"),
           ("norm2.weight", (cout,), "norm_w"), ("norm2.bias", (cout,), "norm_b"),
           ("conv2.weight", (cout, cout, 3), "w"), ("conv2.bias", (cout,), "b")]
    if cin != cout:
        out += [("conv_shortcut.weight", (cout, cin, 1), "w"), ("conv_shortcut.bias", (cout,), "b")]
    return out


def _attn_shapes(c: int) -> List[Tuple[str, tuple, str]]:
    out = [("norm.weight", (c,), "norm_w"), ("norm.bias", (c,), "norm_b"),
           ("proj_in.weight", (c, c), "w"), ("proj_in.bias", (c,), "b")]
    for a in ("attn1", "attn2"):
        n = "norm1" if a == "attn1" else "norm2"
        out += [(f"{n}.weight", (c,), "norm_w"), (f"{n}.bias", (c,), "norm_b")]
        out += [(f"{a}.{p}.weight", (c, c), "w") for p in ("q", "k", "v", "out")]
        out += [(f"{a}.out.bias", (c,), "b")]
    out += [("norm3.weight", (c,), "norm_w"), ("norm3.bias", (c,), "norm_b"),
            ("ff_in.weight", (8 * c, c), "w"), ("ff_in.bias", (8 * c,), "b"),
            ("ff_out.weight", (c, 4 * c), "w"), ("ff_out.bias", (c,), "b"),
            ("proj_out.weight", (c, c), "w"), ("proj_out.bias", (c,), "b")]
    return out


def _unet_blocks(cfg: dict):
    """The UNet's blocks in order: (canonical prefix, kind, shapes)."""
    boc, n, attn = _levels(cfg)
    E = 4 * boc[0]
    L = cfg["n_layers"]
    cin = cfg["out_dims"] + cfg["n_hidden"]
    blocks = [("time.1", "dense", [("weight", (E, boc[0]), "w"), ("bias", (E,), "b")]),
              ("time.2", "dense", [("weight", (E, E), "w"), ("bias", (E,), "b")]),
              ("conv_in", "conv", [("weight", (boc[0], cin, 3), "w"), ("bias", (boc[0],), "b")])]
    skips, ch = [boc[0]], boc[0]
    for i in range(n):
        for j in range(L):
            blocks.append((f"down.{i}.res.{j}", "res", _res_shapes(ch, boc[i], E)))
            ch = boc[i]
            if attn[i]:
                blocks.append((f"down.{i}.attn.{j}", "attn", _attn_shapes(ch)))
            skips.append(ch)
        if i < n - 1:
            blocks.append((f"down.{i}.downsample", "conv", [("weight", (ch, ch, 3), "w"), ("bias", (ch,), "b")]))
            skips.append(ch)
    blocks.append(("mid.res.0", "res", _res_shapes(ch, boc[-1], E)))
    blocks.append(("mid.attn", "attn", _attn_shapes(boc[-1])))
    blocks.append(("mid.res.1", "res", _res_shapes(boc[-1], boc[-1], E)))
    ch = boc[-1]
    rev = list(reversed(boc))
    rev_attn = list(reversed(attn))
    for i in range(n):
        for j in range(L + 1):
            blocks.append((f"up.{i}.res.{j}", "res", _res_shapes(ch + skips.pop(), rev[i], E)))
            ch = rev[i]
            if rev_attn[i]:
                blocks.append((f"up.{i}.attn.{j}", "attn", _attn_shapes(ch)))
        if i < n - 1:
            blocks.append((f"up.{i}.upsample", "conv", [("weight", (ch, ch, 3), "w"), ("bias", (ch,), "b")]))
    blocks.append(("norm_out", "norm", [("weight", (ch,), "norm_w"), ("bias", (ch,), "norm_b")]))
    blocks.append(("conv_out", "conv", [("weight", (cfg["out_dims"], ch, 3), "w"), ("bias", (cfg["out_dims"],), "b")]))
    return blocks


_FLAGSHIP_ATTN = {"attn1.out": "attn1.to_out", "attn2.out": "attn2.to_out", "ff_in": "ff_proj", "ff_out": "ff_out",
                  "attn1.q": "attn1.to_q", "attn1.k": "attn1.to_k", "attn1.v": "attn1.to_v",
                  "attn2.q": "attn2.to_q", "attn2.k": "attn2.to_k", "attn2.v": "attn2.to_v"}
_GENERAL_ATTN = {"attn1.out": "attn1.to_out_0", "attn2.out": "attn2.to_out_0", "ff_in": "ff.net_0.proj",
                 "ff_out": "ff.net_2", "attn1.q": "attn1.to_q", "attn1.k": "attn1.to_k", "attn1.v": "attn1.to_v",
                 "attn2.q": "attn2.to_q", "attn2.k": "attn2.to_k", "attn2.v": "attn2.to_v"}


def _attn_leaf(sub: str, table: dict, block_prefix: str) -> str:
    """The program's name of a transformer block leaf (`sub` canonical)."""
    head, _, leaf = sub.rpartition(".")
    if head in table:
        return f"{block_prefix}{table[head]}.{leaf}"
    return f"{block_prefix}{sub}"


def _program_prefix(canon: str, denoiser: str) -> Tuple[str, str]:
    """(the program's name prefix of a canonical block, prefix of its
    transformer sub-block's leaves relative to it)."""
    p = canon.split(".")
    if denoiser == "flagship":
        if canon == "time.1":
            return "unet.time_mlp1", ""
        if canon == "time.2":
            return "unet.time_mlp2", ""
        if canon in ("conv_in", "conv_out"):
            return f"unet.{canon}", ""
        if canon == "norm_out":
            return "unet.conv_norm_out", ""
        if p[0] == "mid":
            return ("unet.mid_attn", "") if p[1] == "attn" else (f"unet.mid_res_{p[2]}", "")
        if p[2] in ("downsample", "upsample"):
            return f"unet.{p[0]}_{p[1]}_{p[2]}.conv", ""
        return f"unet.{p[0]}_{p[1]}_{p[2]}_{p[3]}", ""
    if canon == "time.1":
        return "unet.time_embedding.linear_1", ""
    if canon == "time.2":
        return "unet.time_embedding.linear_2", ""
    if canon in ("conv_in", "conv_out"):
        return f"unet.{canon}", ""
    if canon == "norm_out":
        return "unet.conv_norm_out", ""
    if p[0] == "mid":
        if p[1] == "attn":
            return "unet.mid_block.attentions_0", "transformer_blocks_0."
        return f"unet.mid_block.resnets_{p[2]}", ""
    blk = f"unet.{p[0]}_blocks_{p[1]}"
    if p[2] == "downsample":
        return f"{blk}.downsamplers_0.conv", ""
    if p[2] == "upsample":
        return f"{blk}.upsamplers_0.conv", ""
    if p[2] == "res":
        return f"{blk}.resnets_{p[3]}", ""
    return f"{blk}.attentions_{p[3]}", "transformer_blocks_0."


_OUTER = ("norm.", "proj_in.", "proj_out.")  # a transformer's leaves outside its transformer_blocks_0


def canonical_names(cfg: dict) -> Dict[str, str]:
    """canonical name -> the program's state-dict name, for the Unit2Mel
    module of configuration `cfg` (its `denoiser` picks the layout)."""
    den = cfg["program"]["denoiser"]
    table = _FLAGSHIP_ATTN if den == "flagship" else _GENERAL_ATTN
    out = {"unit_embed.weight": "unit_embed.weight", "unit_embed.bias": "unit_embed.bias",
           "spk_embed.weight": "spk_embed.weight", "aug_shift_embed.weight": "aug_shift_embed.weight"}
    for canon, kind, shapes in _unet_blocks(cfg):
        prefix, inner = _program_prefix(canon, den)
        for leaf, _, _ in shapes:
            if kind == "attn":
                sub_prefix = "" if leaf.startswith(_OUTER) else inner
                out[f"{canon}.{leaf}"] = _attn_leaf(leaf, table, f"{prefix}.{sub_prefix}")
            else:
                out[f"{canon}.{leaf}"] = f"{prefix}.{leaf}"
    return out


def unit2mel_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(program name, shape, kind) of every Unit2Mel leaf.  kind: 'w' a
    product's weight, 'b' its bias (both served in the configuration's
    dtype), 'norm_w' / 'norm_b' a norm's scale and offset, 'emb' an
    embedding (float32)."""
    H = cfg["n_hidden"]
    spec = [("unit_embed.weight", (H, cfg["input_channel"]), "w"), ("unit_embed.bias", (H,), "b"),
            ("spk_embed.weight", (cfg["n_spk"], H), "emb"), ("aug_shift_embed.weight", (H, 1), "w")]
    names = canonical_names(cfg)
    for canon, _, shapes in _unet_blocks(cfg):
        spec += [(names[f"{canon}.{leaf}"], shape, kind) for leaf, shape, kind in shapes]
    return spec


def vocoder_spec(vcfg: dict) -> List[Tuple[str, tuple, str]]:
    """(program name, shape, kind) of every HiFi-VAEGAN generator leaf
    ('wt': a transposed convolution's weight, (in, out, k))."""
    uic = vcfg["upsample_initial_channel"]
    spec = [("conv_pre.weight", (uic, vcfg["inter_channels"], 7), "w"), ("conv_pre.bias", (uic,), "b")]
    ch = uic
    for i, (u, k) in enumerate(zip(vcfg["upsample_rates"], vcfg["upsample_kernel_sizes"])):
        out = uic // (2 ** (i + 1))
        spec += [(f"up_{i}.weight", (ch, out, k), "wt"), (f"up_{i}.bias", (out,), "b")]
        ch = out
        for j, (rk, dil) in enumerate(zip(vcfg["resblock_kernel_sizes"], vcfg["resblock_dilation_sizes"])):
            for m in range(len(dil)):
                for c in ("conv1", "conv2"):
                    spec += [(f"res_{i}_{j}.{c}_{m}.weight", (ch, ch, rk), "w"), (f"res_{i}_{j}.{c}_{m}.bias", (ch,), "b")]
    spec += [("conv_post.weight", (1, ch, 7), "w"), ("conv_post.bias", (1,), "b")]
    return spec


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _group_norm(x, w, b, groups, eps):
    """x (B, T, C) -> (B, T, C)."""
    return F.group_norm(x.transpose(1, 2), groups, w, b, eps).transpose(1, 2)


class UNetRef:
    """The denoiser over canonical names: eps = UNet([x_t ++ cond], t)."""

    GROUPS = 8

    def __init__(self, W: Dict[str, torch.Tensor], cfg: dict, ops: Products):
        self.W, self.cfg, self.ops = W, cfg, ops

    def _dense(self, name, x):
        b = self.W.get(f"{name}.bias")
        return self.ops.linear(x, self.W[f"{name}.weight"], b)

    def _conv(self, name, x, stride=1):
        """x (B, T, C); 'same' padding for odd kernels."""
        w = self.W[f"{name}.weight"]
        y = self.ops.conv(x.transpose(1, 2), w, self.W[f"{name}.bias"], stride, (w.shape[-1] - 1) // 2)
        return y.transpose(1, 2)

    def _norm(self, name, x, eps):
        return _group_norm(x, self.W[f"{name}.weight"], self.W[f"{name}.bias"], self.GROUPS, eps)

    def _res(self, p, x, temb):
        h = self._conv(f"{p}.conv1", F.silu(self._norm(f"{p}.norm1", x, 1e-5)))
        scale, shift = self._dense(f"{p}.time_emb_proj", F.silu(temb))[:, None, :].chunk(2, dim=-1)
        h = self._norm(f"{p}.norm2", h, 1e-5) * (1 + scale) + shift
        h = self._conv(f"{p}.conv2", F.silu(h))
        if f"{p}.conv_shortcut.weight" in self.W:
            x = self._conv(f"{p}.conv_shortcut", x)
        return x + h

    def _layer_norm(self, name, x):
        return F.layer_norm(x, x.shape[-1:], self.W[f"{name}.weight"], self.W[f"{name}.bias"], 1e-6)

    def _self_attention(self, p, x):
        B, T, C = x.shape
        heads = self.cfg["n_heads"]
        q, k, v = (self._dense(f"{p}.{n}", x).reshape(B, T, heads, C // heads) for n in ("q", "k", "v"))
        return self._dense(f"{p}.out", self.ops.attention(q, k, v).reshape(B, T, C))

    def _transformer(self, p, x):
        h = self._dense(f"{p}.proj_in", self._norm(f"{p}.norm", x, 1e-6))
        h = h + self._self_attention(f"{p}.attn1", self._layer_norm(f"{p}.norm1", h))
        h = h + self._self_attention(f"{p}.attn2", self._layer_norm(f"{p}.norm2", h))
        a, g = self._dense(f"{p}.ff_in", self._layer_norm(f"{p}.norm3", h)).chunk(2, dim=-1)
        h = h + self._dense(f"{p}.ff_out", a * F.gelu(g))
        return self._dense(f"{p}.proj_out", h) + x

    def __call__(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        boc, n, attn = _levels(cfg)
        L = cfg["n_layers"]
        half = boc[0] // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=x.device) / half)
        args = t.float()[:, None] * freqs[None, :]
        temb = self._dense("time.2", F.silu(self._dense("time.1", torch.cat([torch.cos(args), torch.sin(args)], -1))))
        h = self._conv("conv_in", x)
        skips = [h]
        for i in range(n):
            for j in range(L):
                h = self._res(f"down.{i}.res.{j}", h, temb)
                if attn[i]:
                    h = self._transformer(f"down.{i}.attn.{j}", h)
                skips.append(h)
            if i < n - 1:
                h = self._conv(f"down.{i}.downsample", h, stride=2)
                skips.append(h)
        h = self._res("mid.res.0", h, temb)
        h = self._transformer("mid.attn", h)
        h = self._res("mid.res.1", h, temb)
        rev_attn = list(reversed(attn))
        for i in range(n):
            for j in range(L + 1):
                h = self._res(f"up.{i}.res.{j}", torch.cat([h, skips.pop()], dim=-1), temb)
                if rev_attn[i]:
                    h = self._transformer(f"up.{i}.attn.{j}", h)
            if i < n - 1:
                h = self._conv(f"up.{i}.upsample", torch.repeat_interleave(h, 2, dim=1))
        return self._conv("conv_out", F.silu(self._norm("norm_out", h, 1e-5)))


def condition(W: Dict[str, torch.Tensor], units: torch.Tensor, spk: torch.Tensor, ops: Products) -> torch.Tensor:
    """units (B, T, C_in), spk (B,) 1-based -> (B, T, n_hidden); no pitch
    shift is given, so the aug-shift embedding adds nothing."""
    x = ops.linear(units, W["unit_embed.weight"], W["unit_embed.bias"])
    return x + W["spk_embed.weight"][spk - 1][:, None, :]


# ---------------------------------------------------------------------------
# the sampler: multistep DPM-Solver++ (order 2, time-uniform)
# ---------------------------------------------------------------------------

class _VPSchedule:
    """Continuous VP schedule over the linear betas: log alpha interpolated
    piecewise-linearly over t in [1/N, 1]."""

    def __init__(self, timesteps: int, beta_start: float, beta_end: float):
        betas = np.linspace(beta_start, beta_end, timesteps)
        self.N = timesteps
        self.t = (np.arange(timesteps) + 1.0) / timesteps
        self.log_alpha = 0.5 * np.cumsum(np.log(1.0 - betas))

    def log_mean(self, t):
        return np.interp(t, self.t, self.log_alpha)

    def alpha(self, t):
        return np.exp(self.log_mean(t))

    def sigma(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.log_mean(t)))

    def lam(self, t):
        lm = self.log_mean(t)
        return lm - 0.5 * np.log(1.0 - np.exp(2.0 * lm))


def dpm_solver_pp(eps_fn, x: torch.Tensor, sched: _VPSchedule, steps: int) -> torch.Tensor:
    """Multistep DPM-Solver++ (2M): `steps` model evaluations from t=1 to
    t=1/N, the first step of order 1."""
    ts = np.linspace(1.0, 1.0 / sched.N, steps + 1)
    lam, sig, alp = sched.lam(ts), sched.sigma(ts), sched.alpha(ts)
    B = x.shape[0]

    def x0(x, i):
        t_model = torch.full((B,), (ts[i] - 1.0 / sched.N) * 1000.0, dtype=torch.float32, device=x.device)
        return (x - sig[i] * eps_fn(x, t_model)) / alp[i]

    m0, m1, h_prev = x0(x, 0), None, None
    for i in range(steps):
        h = lam[i + 1] - lam[i]
        phi = math.expm1(-h)
        x = (sig[i + 1] / sig[i]) * x - (alp[i + 1] * phi) * m0
        if m1 is not None:
            x = x - 0.5 * (alp[i + 1] * phi) * (m0 - m1) / (h_prev / h)
        h_prev = h
        if i + 1 < steps:
            m0, m1 = x0(x, i + 1), m0
    return x


def bucket(n: int, multiple: int = 64) -> int:
    """The length the serving pipeline pads a request of n frames to."""
    return max(multiple, -(-n // multiple) * multiple)


def unit2mel(W, units, spk, x_init, cfg: dict, ops: Products) -> torch.Tensor:
    """units (B, T, C_in) at the request's length, x_init (B, bucket(T),
    M) -> the sampled latents (B, bucket(T), M).  The units are padded to
    the bucket with their last frame, as a serving pipeline pads them."""
    if cfg["method"] != "dpm-solver":
        raise ValueError(f"the reference samples with DPM-Solver++ only, not {cfg['method']!r}")
    B, T = units.shape[:2]
    Tb = bucket(T)
    units = torch.cat([units, units[:, -1:].expand(B, Tb - T, -1)], dim=1)
    cond = condition(W, units, spk, ops)
    unet = UNetRef(W, cfg, ops)
    sched = _VPSchedule(cfg["timesteps"], cfg["beta_start"], cfg["beta_end"])
    steps = cfg["k_step_max"] // cfg["infer_speedup"]
    if steps < 10:
        raise ValueError("the reference follows the multistep solver's order-2 steps, which it runs at 10 steps or more")
    x = dpm_solver_pp(lambda x, t: unet(torch.cat([x, cond], dim=-1), t), x_init.float(), sched, steps)
    return x / cfg["acoustic_scale"]


def vocoder(W, z: torch.Tensor, vcfg: dict, ops: Products) -> torch.Tensor:
    """Latents (B, T, C) -> waveform (B, T * hop) (HiFi-GAN V1 generator)."""
    slope = 0.1
    x = ops.conv(z.transpose(1, 2), W["conv_pre.weight"], W["conv_pre.bias"], padding=3)
    kinds = list(zip(vcfg["resblock_kernel_sizes"], vcfg["resblock_dilation_sizes"]))
    for i, (u, k) in enumerate(zip(vcfg["upsample_rates"], vcfg["upsample_kernel_sizes"])):
        x = ops.conv_transpose(F.leaky_relu(x, slope), W[f"up_{i}.weight"], W[f"up_{i}.bias"], u, (k - u + 1) // 2)
        acc = None
        for j, (rk, dil) in enumerate(kinds):
            y = x
            for m, d in enumerate(dil):
                p = f"res_{i}_{j}"
                t = ops.conv(F.leaky_relu(y, slope), W[f"{p}.conv1_{m}.weight"], W[f"{p}.conv1_{m}.bias"],
                             padding=(rk * d - d) // 2, dilation=d)
                t = ops.conv(F.leaky_relu(t, slope), W[f"{p}.conv2_{m}.weight"], W[f"{p}.conv2_{m}.bias"],
                             padding=(rk - 1) // 2)
                y = y + t
            acc = y if acc is None else acc + y
        x = acc / len(kinds)
    x = ops.conv(F.leaky_relu(x, 0.01), W["conv_post.weight"], W["conv_post.bias"], padding=3)
    return torch.tanh(x)[:, 0, :]


@torch.no_grad()
def synthesize(u2m_W: Dict[str, torch.Tensor], voc_W: Dict[str, torch.Tensor], units, spk, x_init, cfg: dict,
               precision: str = "f32") -> torch.Tensor:
    """The reference's answer to one request: units (B, T, C_in), spk (B,)
    1-based, x_init (B, bucket(T), M) -> waveform (B, T * hop) float32.
    `u2m_W` is keyed by canonical names (`canonical_weights`), `voc_W` by the
    generator's names; both float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops = Products(precision)
    T = units.shape[1]
    mel = unit2mel(u2m_W, units.float(), spk, x_init, cfg, ops)
    wav = vocoder(voc_W, mel, cfg["vocoder"], ops)
    return wav[:, : T * int(np.prod(cfg["vocoder"]["upsample_rates"]))]


def canonical_weights(program_weights: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    """The Unit2Mel weights (program names) under canonical names, float32."""
    return {canon: program_weights[name].float() for canon, name in canonical_names(cfg).items()}
