"""The denoiser's CUDA graphs (`models/diffusion/graphs.py`) and the rule
that decides when `Unit2MelSystem` replays an evaluation from one.

On the CPU no graph engages: every evaluation counts as a bypass and the
sampler's output equals the eager module's.  The rule is checked on an
input that reports a CUDA device, and the int8 and fused B=1 branches with
the rule made to engage, so each bypass case is seen on its own.  The
cache's bookkeeping (warm-up, capture, replay, the LRU bound, the
storage check, the kernels' launch counters) runs here with its two CUDA
steps swapped for plain calls; `tests/test_torch_kernels_cuda.py` replays
real graphs on the card.
"""

import copy
from types import SimpleNamespace

import pytest
import torch

from latent_diffusion_speech_tpu_torch.models.diffusion import graphs
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
from latent_diffusion_speech_tpu_torch.ops.kernels import build
from latent_diffusion_speech_tpu_torch.ops.kernels import flash_attention as k5
from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as k23
from latent_diffusion_speech_tpu_torch.utils import profiler

SMALL = dict(input_channel=16, n_spk=4, out_dims=6, n_hidden=8, block_out_channels=(8, 16, 16), n_heads=2,
             n_layers=1)
GRAPH_COUNTERS = ("denoiser.graph_warmups", "denoiser.graph_captures", "denoiser.graph_replays")


@pytest.fixture(autouse=True)
def clean():
    profiler.disable()
    profiler.drain()
    yield
    profiler.disable()
    profiler.drain()


def system(**kw):
    cfg = {**SMALL, **{k: v for k, v in kw.items() if k in ("denoiser", "attn_impl")}}
    return Unit2MelSystem(Unit2MelConfig(**cfg), device="cpu", seed=0,
                          **{k: v for k, v in kw.items() if k in ("unet_impl", "weight_quant")})


def on_card(B=2, T=64):
    """An input that reports a CUDA device (the rule reads its device and shape)."""
    return SimpleNamespace(is_cuda=True, shape=(B, T, SMALL["out_dims"] + SMALL["n_hidden"]))


@pytest.mark.parametrize("kw", [dict(denoiser="general", attn_impl="pallas"), dict(denoiser="flagship"),
                                dict(denoiser="flagship", unet_impl="pallas")],
                         ids=["general", "flagship", "flagship-pallas"])
def test_no_graph_engages_on_the_cpu(kw):
    """A 20-evaluation DPM-Solver++ sample at B=2: every evaluation a
    bypass, no warm-up, capture or replay, and the output equal to the
    same sample through `module.denoise`."""
    sys_ = system(**kw)
    gen = torch.Generator().manual_seed(0)
    cond = torch.randn((2, 40, SMALL["n_hidden"]), generator=gen)
    x0 = torch.randn((2, 40, SMALL["out_dims"]), generator=gen)
    eager = copy.copy(sys_.diffusion)
    eager.denoise_fn = lambda params, x, t: sys_.module.denoise(x, t)
    profiler.enable()
    got = sys_.diffusion.sample(cond, method="dpm-solver", infer_speedup=50, x_init=x0)
    _, counters = profiler.drain()
    assert counters["denoiser.graph_bypasses"] == 20
    assert not set(GRAPH_COUNTERS) & set(counters)
    assert len(sys_.graphs) == 0
    assert torch.equal(got, eager.sample(cond, method="dpm-solver", infer_speedup=50, x_init=x0))


def test_the_rule_engages_on_the_card():
    sys_ = system(denoiser="general", attn_impl="pallas")
    with torch.no_grad():
        assert sys_.graph_engages(on_card())
        assert not sys_.graph_engages(torch.zeros(on_card().shape))  # the CPU


@pytest.mark.parametrize("case", ["grad", "training"])
def test_the_rule_fails_with_grad_or_in_training(case):
    """Grad mode on (`p_losses`) and the module in training mode keep an
    evaluation on the eager module."""
    sys_ = system()
    if case == "training":
        sys_.module.train()
    with torch.set_grad_enabled(case == "grad"):
        assert not sys_.graph_engages(on_card())


@pytest.mark.parametrize("case", ["packed_b1", "int8"])
def test_int8_and_the_fused_b1_branch_bypass_the_graphs(monkeypatch, case):
    """With the rule made to engage, the int8 weights (any B) and the fused
    kernel's B=1 branch still run on their own paths and count bypasses;
    the packed flagship at B=2 is the eager branch and replays."""
    sys_ = system(**{"packed_b1": dict(unet_impl="pallas"), "int8": dict(weight_quant="int8")}[case])
    packed = sys_._prepare_sample_params()
    replayed = []
    monkeypatch.setattr(sys_, "graph_engages", lambda x: True)
    monkeypatch.setattr(sys_, "graphs", lambda module, x, t: replayed.append(x.shape[0]) or module(x, t))
    profiler.enable()
    with torch.no_grad():
        for B in (1, 2):
            x = torch.randn((B, 64, SMALL["out_dims"] + SMALL["n_hidden"]))
            assert sys_._denoise(packed, x, torch.full((B,), 10.0)).shape == (B, 64, SMALL["out_dims"])
    assert replayed == ([2] if case == "packed_b1" else [])
    assert profiler.drain()[1] == {"denoiser.graph_bypasses": 1 if case == "packed_b1" else 2}


def test_the_rule_reads_the_module_mode_at_each_evaluation():
    sys_ = system()
    with torch.no_grad():
        sys_.module.train()
        assert not sys_.graph_engages(on_card())
        sys_.module.eval()
        assert sys_.graph_engages(on_card())


class PlainGraph:
    """`replay()` computes the captured call again from its static inputs
    into its static output, as a CUDA graph's replay does."""

    def __init__(self, module, x, t, out):
        self.module, self.x, self.t, self.out = module, x, t, out

    def replay(self):
        self.out.copy_(self.module(self.x, self.t))


@pytest.fixture
def plain_steps(monkeypatch):
    """`DenoiserGraphs` with its warm-up and capture run as plain calls on
    the CPU; a capture counts 3 K5 launches, 1 plain route, 2 K4 launches."""
    launches = {(k5.__name__, "launches"): 3, (k5.__name__, "plain_routes"): 1, (k4.__name__, "launches"): 2}

    def warm_up(self, module, x, t):
        return module(x, t)

    def capture(self, module, x, t):
        x, t = x.clone(), t.clone()
        out = module(x, t)
        return graphs._Graph(PlainGraph(module, x, t, out), x, t, out, launches)

    monkeypatch.setattr(graphs.DenoiserGraphs, "_warm_up", warm_up)
    monkeypatch.setattr(graphs.DenoiserGraphs, "_capture", capture)


class Denoiser(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 4)

    def forward(self, x, t):
        return self.lin(x) + t[:, None, None]


def module():
    return Denoiser()


def call(g, m, x, t):
    with torch.no_grad():
        return g(m, x, t)


def test_warm_up_then_capture_then_replays(plain_steps):
    """Per key: the first evaluation warms up, the second captures, the rest
    replay with their own x and t copied in; each output is a clone, so the
    next replay leaves it be; counters add up to the evaluations."""
    m, g = module(), graphs.DenoiserGraphs()
    xs = [torch.randn(2, 3, 4) for _ in range(5)]
    t = torch.zeros(2)
    profiler.enable()
    outs = [call(g, m, x, t) for x in xs]
    assert profiler.drain()[1] == {"denoiser.graph_warmups": 1, "denoiser.graph_captures": 1,
                                   "denoiser.graph_replays": 3}
    with torch.no_grad():
        for x, out in zip(xs, outs):
            assert torch.equal(out, m(x, t))
    assert len(g) == 1
    call(g, m, torch.randn(1, 3, 4), t)  # another shape: its own warm-up
    call(g, m, xs[0], t.long())  # another dtype of t, likewise
    assert len(g) == 1


def test_replays_add_their_captures_launches(plain_steps):
    m, g = module(), graphs.DenoiserGraphs()
    x, t = torch.randn(2, 3, 4), torch.zeros(2)
    call(g, m, x, t)
    call(g, m, x, t)
    before = (k5.launches, k5.plain_routes, k4.launches)
    call(g, m, x, t)
    call(g, m, x, t)
    assert (k5.launches - before[0], k5.plain_routes - before[1], k4.launches - before[2]) == (6, 2, 4)


def test_every_wrapper_registers_its_launch_counters():
    """What a replay adds reaches every counter a wrapper keeps."""
    kept = {(m.__name__, name) for m in (k1, k4, k5, k6, k23) for name, v in vars(m).items()
            if type(v) is int and (name.endswith("launches") or name == "plain_routes")}
    assert kept == {(k5.__name__, "plain_routes"), (k4.__name__, "bwd_launches"),
                    *((m.__name__, "launches") for m in (k1, k4, k5, k6, k23))}
    assert kept <= set(build.launch_counts())
    before = build.launch_counts()
    build.add_launches({(k6.__name__, "launches"): 2})
    assert k6.launches == before[(k6.__name__, "launches")] + 2
    k6.launches -= 2


def test_the_cache_keeps_the_most_recently_used_keys(plain_steps):
    m, g = module(), graphs.DenoiserGraphs()
    t = torch.zeros(1)
    first = torch.randn(1, 1, 4)
    call(g, m, first, t)
    call(g, m, first, t)
    for n in range(2, graphs.MAX_KEYS + 1):
        call(g, m, torch.randn(1, n, 4), t)
    call(g, m, first, t)  # a replay: the oldest key is now the length-2 one
    assert len(g) == 1
    call(g, m, torch.randn(1, graphs.MAX_KEYS + 1, 4), t)
    profiler.enable()
    call(g, m, first, t)
    call(g, m, torch.randn(1, 2, 4), t)
    assert profiler.drain()[1] == {"denoiser.graph_replays": 1, "denoiser.graph_warmups": 1}


def test_check_drops_the_graphs_when_storage_moves(plain_steps):
    """An in-place update keeps the graphs (and the replay computes with the
    new values); a parameter moved to new storage drops them."""
    m, g = module(), graphs.DenoiserGraphs()
    x, t = torch.randn(2, 3, 4), torch.zeros(2)
    call(g, m, x, t)
    call(g, m, x, t)
    with torch.no_grad():
        m.lin.weight.add_(1.0)
    g.check(m)
    assert len(g) == 1
    with torch.no_grad():
        assert torch.equal(call(g, m, x, t), m(x, t))
    m.lin.weight.data = m.lin.weight.data.clone()
    g.check(m)
    assert len(g) == 0
    profiler.enable()
    call(g, m, x, t)
    assert profiler.drain()[1] == {"denoiser.graph_warmups": 1}


def test_sampling_checks_the_cache_once_a_call(monkeypatch):
    sys_ = system()
    seen = []
    monkeypatch.setattr(sys_.graphs, "check", seen.append)
    sys_.infer(torch.randn((1, 16, SMALL["input_channel"])), spk_id=torch.ones((1, 16), dtype=torch.long),
               method="dpm-solver", infer_speedup=50)
    assert seen == [sys_.module.unet]
