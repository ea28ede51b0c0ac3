"""A whole run at tiny widths on the CPU (the chip check skipped), with the
timed path broken underneath: `correct` comes out false for each fault a
serving cell can have, and true without one."""

import dataclasses

import numpy as np
import pytest
import torch

from lds_bench import manifest, program
from lds_bench.run import run_cell
from lds_bench.tests import tiny

BENCH = manifest.load()
CELLS = {"flagship.solo": ("flagship", "solo"), "general.b32": ("general", "b32")}


def run(cell, serve=None, seed=4):
    cname, tname = CELLS[cell]
    return run_cell(tiny.config(cname), tiny.traffic(tname), manifest.end_to_end(BENCH, cell),
                    manifest.per_layer(BENCH, cell), seed, 0.5, False, torch.device("cpu"), serve=serve)


def altered(fn):
    """A serve that alters each request (`fn(request) -> request`) where it is produced."""
    def serve(pipe, request, sampler, span=None):
        return program.serve(pipe, fn(request), sampler)
    return serve


def half_batch(pipe, request, sampler, span=None):
    """Only the first half of the batch computed; its answers fill the rest."""
    half = request.batch // 2
    part = dataclasses.replace(request, units=request.units[:half], spk=request.spk[:half],
                               x_init=request.x_init[:half])
    wav = program.serve(pipe, part, sampler)
    return np.concatenate([wav, wav[: request.batch - half]])


def one_sample_late(pipe, request, sampler, span=None):
    wav = program.serve(pipe, request, sampler)
    wav[0] = np.roll(wav[0], 1)
    return wav


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sampler_state_unchanged(cell, monkeypatch):
    from latent_diffusion_speech_tpu_torch.models.diffusion import gaussian

    monkeypatch.setattr(gaussian, "dpmpp_sample", lambda eps_fn, ns, x, steps, order=2: x)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_speaker_off_by_one(cell):
    serve = altered(lambda r: dataclasses.replace(r, spk=r.spk % 5 + 1))
    assert not run(cell, serve)["correct"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_answer_one_sample_late(cell):
    assert not run(cell, one_sample_late)["correct"]


def test_half_the_batch_left_out():
    assert not run("general.b32", half_batch)["correct"]


def test_a_failed_call_is_not_correct():
    def broken(pipe, request, sampler, span=None):
        if span is None:  # the warm-up serves; the window's calls fail
            return program.serve(pipe, request, sampler)
        raise RuntimeError("lost")

    res = run("flagship.solo", broken)
    assert not res["correct"] and res["failed"] == res["attempted"] > 0
