"""The plain reference against the program at tiny widths on the CPU, in
float32: the weights the benchmark draws load into the program's modules
by name, and both sides give the same waveform."""

import pytest
import torch

from lds_bench import check, program
from lds_bench.reference.acoustic import canonical_names, unit2mel_spec, vocoder_spec
from lds_bench.run import prepare
from lds_bench.tests import tiny


@pytest.mark.parametrize("name", ["flagship", "general"])
def test_spec_is_the_program_state_dict(name):
    """Every leaf the benchmark draws is a leaf of the program's module,
    with its shape, and none is missing (at the shipped widths)."""
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2Mel
    from latent_diffusion_speech_tpu_torch.models.vaegan.models import Generator
    from lds_bench import manifest

    cfg = manifest.config(name)
    with torch.device("meta"):
        u2m = Unit2Mel(program.unit2mel_config(cfg)).state_dict()
        voc = Generator(program.vaegan_config(cfg["vocoder"])).state_dict()
    spec = {n: s for n, s, _ in unit2mel_spec(cfg)}
    assert spec == {k: tuple(v.shape) for k, v in u2m.items()}
    assert {n: s for n, s, _ in vocoder_spec(cfg["vocoder"])} == {k: tuple(v.shape) for k, v in voc.items()}
    assert len(set(canonical_names(cfg).values())) == len(spec)


@pytest.mark.parametrize("name,traffic", [("flagship", "solo"), ("general", "b32")])
def test_reference_matches_the_program_in_f32(name, traffic):
    cfg, t = tiny.config(name), tiny.traffic(traffic)
    dev = torch.device("cpu")
    run_cfg, u2m_w, voc_w, reqs = prepare(cfg, t, 3, dev)
    pipe = program.build(run_cfg, u2m_w, voc_w, dev)
    W, V = check.reference_weights(u2m_w, voc_w, run_cfg)
    for r in reqs[:2]:
        served = program.serve(pipe, r, t["sampler"])
        ref = check.reference_answers(W, V, run_cfg, r, rows=3)
        assert max(check.rel_gaps(served, ref)) < 1e-4
        assert ref.abs().max() > 1e-3  # a waveform, not silence


def test_rel_gaps_reads_failures_as_infinite():
    ref = torch.ones(2, 5)
    assert check.rel_gaps(None, ref) == [float("inf")] * 2
    assert check.rel_gaps(torch.ones(2, 4).numpy(), ref) == [float("inf")] * 2
    bad = torch.ones(2, 5)
    bad[1, 2] = float("nan")
    assert check.rel_gaps(bad.numpy(), ref) == [float("inf")] * 2
    assert check.rel_gaps((2 * ref).numpy(), ref) == [1.0, 1.0]


def test_sample_holds_the_longest_and_repeats():
    frames = [5, 9, 3, 9, 7, 1, 2, 8, 6]
    a = check.sample(frames, 4, 3)
    assert a == check.sample(frames, 4, 3) and len(a) == 3 and 1 in a
    assert check.sample(frames[:2], 4, 3) == [0, 1]
