"""`utils/profiler.py`: the port's tracer, and the spans and counters the
acoustic path records with it.

Off, `span` hands out one shared no-op context and `count` counts nothing;
on (`enable()`, or while a `torch.profiler` session runs), spans carry
their parent's name and their root's request id, stacks are per thread,
stamps are `time.time_ns`, and `drain` empties.  A tiny general-denoiser
`TTSPipeline` on the CPU records the tree the per-layer metrics read.
"""

import threading
import time

import pytest
import torch

from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1D, UNet1DConfig
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
from latent_diffusion_speech_tpu_torch.ops.kernels.unet_fused import _table, pack_unet_params
from latent_diffusion_speech_tpu_torch.utils import profiler

VAEGAN = dict(sampling_rate=8000, inter_channels=6, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
              upsample_rates=(4, 2), upsample_initial_channel=16, upsample_kernel_sizes=(8, 4))
GENERAL = dict(input_channel=16, n_spk=4, out_dims=6, n_hidden=8, block_out_channels=(8, 16, 16), n_heads=2,
               n_layers=1, denoiser="general", attn_impl="pallas")
FLAGSHIP = dict(GENERAL, denoiser="flagship", attn_impl="xla")


@pytest.fixture(autouse=True)
def clean():
    profiler.disable()
    profiler.drain()
    yield
    profiler.disable()
    profiler.drain()


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s[0], []).append(s)
    return out


def test_off_hands_out_one_shared_context_and_records_nothing():
    a, b = profiler.span("a"), profiler.span("b")
    assert a is b
    with a:
        with b:
            profiler.count("c", 3)
    assert profiler.drain() == ([], {})


def test_nesting_gives_parents_and_one_request_a_root():
    profiler.enable()
    with profiler.span("root"):
        with profiler.span("a"):
            with profiler.span("b"):
                pass
        with profiler.span("c"):
            pass
    with profiler.span("next"):
        pass
    spans, _ = profiler.drain()
    names = by_name(spans)
    assert [s[0] for s in spans] == ["b", "a", "c", "root", "next"]  # in the order they closed
    assert [names[n][0][2] for n in ("root", "a", "b", "c", "next")] == [None, "root", "a", "root", None]
    assert len({s[1] for s in spans if s[0] != "next"}) == 1
    assert names["next"][0][1] != names["root"][0][1]


def test_stacks_are_per_thread():
    """A span opened on one thread while another thread's span is open is
    a root of its own request there."""
    profiler.enable()
    inside = threading.Event()
    done = threading.Event()

    def other():
        inside.wait(timeout=10)
        with profiler.span("other"):
            pass
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with profiler.span("main"):
        inside.set()
        assert done.wait(timeout=10)
    t.join(timeout=10)
    assert not t.is_alive()
    names = by_name(profiler.drain()[0])
    assert names["other"][0][2] is None and names["main"][0][2] is None
    assert names["other"][0][1] != names["main"][0][1]


def test_drain_empties_spans_and_counters():
    profiler.enable()
    with profiler.span("x"):
        profiler.count("n")
        profiler.count("n", 4)
    spans, counters = profiler.drain()
    assert len(spans) == 1 and counters == {"n": 5}
    assert profiler.drain() == ([], {})


def test_stamps_are_the_host_clock_of_time_ns():
    profiler.enable()
    t0 = time.time_ns()
    with profiler.span("x"):
        time.sleep(0.002)
    t1 = time.time_ns()
    (_, _, _, start, end), = profiler.drain()[0]
    assert t0 <= start < end <= t1
    assert end - start >= 2_000_000


def test_records_while_a_torch_profiler_session_runs():
    """Disabled, the tracer still records inside a `torch.profiler`
    session, and stops with it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.span("profiled"):
            profiler.count("n")
    with profiler.span("after"):
        profiler.count("n")
    spans, counters = profiler.drain()
    assert [s[0] for s in spans] == ["profiled"] and counters == {"n": 1}


def test_phase_table_counts_one_build_then_hits():
    cfg = UNet1DConfig(in_channels=16, out_channels=8, block_out_channels=(8, 16), n_heads=2, layers_per_block=1)
    packed = pack_unet_params(UNet1D(cfg).eval(), cfg)
    profiler.enable()
    first = _table(packed, 64)
    assert _table(packed, 64) is first
    spans, counters = profiler.drain()
    assert counters == {"unet_fused.table_builds": 1}
    assert [s[0] for s in spans] == ["unet_fused.table_build"]
    _table(packed, 128)
    assert profiler.drain()[1] == {"unet_fused.table_builds": 1}


def pipeline(cfg):
    diffusion = Unit2MelSystem(Unit2MelConfig(**cfg), device="cpu")
    return TTSPipeline(diffusion, Vocoder("hifi-vaegan", VAEGANConfig(**VAEGAN), device="cpu"))


@pytest.fixture(scope="module")
def general_pipe():
    return pipeline(GENERAL)


def serve(pipe, batch, frames):
    units = torch.randn(batch, frames, GENERAL["input_channel"], generator=torch.Generator().manual_seed(0))
    profiler.enable()
    wav = pipe.infer(units, spk_id=1, method="dpm-solver", infer_speedup=50, generator=torch.Generator())
    profiler.disable()
    return wav, profiler.drain()


@pytest.mark.parametrize("cfg", [GENERAL, FLAGSHIP], ids=["general", "flagship"])
def test_eager_pipeline_records_the_acoustic_path(general_pipe, cfg):
    """tts.infer holds the condition, the sampler and the vocoder; the
    sampler holds the weight preparation and 20 evaluations, each over
    every UNet level (the general UNet, and the flagship's at B > 1); one
    request id runs through them all."""
    _, (spans, _) = serve(general_pipe if cfg is GENERAL else pipeline(cfg), 2, 40)
    names = by_name(spans)
    parents = {n: {s[2] for s in v} for n, v in names.items()}
    levels = len(GENERAL["block_out_channels"])
    unet = [f"unet.down.{i}" for i in range(levels)] + ["unet.mid"] + [f"unet.up.{i}" for i in range(levels)]
    assert set(names) == {"tts.infer", "diffusion.condition", "diffusion.sample", "diffusion.prepare",
                          "denoiser.eval", "vocoder.infer", *unet}
    assert len(names["tts.infer"]) == 1 and parents["tts.infer"] == {None}
    assert parents["diffusion.condition"] == parents["diffusion.sample"] == parents["vocoder.infer"] == {"tts.infer"}
    assert parents["diffusion.prepare"] == parents["denoiser.eval"] == {"diffusion.sample"}
    assert len(names["denoiser.eval"]) == 20
    assert all(len(names[n]) == 20 and parents[n] == {"denoiser.eval"} for n in unet)
    assert len({s[1] for s in spans}) == 1
    (_, _, _, lo, hi), = names["tts.infer"]
    assert all(lo <= s[3] <= s[4] <= hi for s in spans)


@pytest.mark.parametrize("batch,frames,bucket", [(1, 40, 64), (3, 64, 64), (2, 65, 128)])
def test_frame_counters_hold_the_request_and_its_bucket(general_pipe, batch, frames, bucket):
    wav, (_, counters) = serve(general_pipe, batch, frames)
    assert counters == {"tts.frames_requested": batch * frames, "diffusion.frames_denoised": batch * bucket}
    assert wav.shape == (batch, frames * 8)
