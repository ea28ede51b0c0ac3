"""`utils/profiler.py`: the trace helper against the JAX package's.

`profile_trace(logdir)` writes a Chrome trace under `logdir` holding the
spans `annotate` names; disabled, it writes nothing.  Both packages take
the same arguments with the same defaults.
"""

import inspect
import json

import torch

from latent_diffusion_speech_tpu.utils import profiler as j_profiler
from latent_diffusion_speech_tpu_torch.utils.profiler import annotate, profile_trace


def test_trace_holds_the_annotated_span(tmp_path):
    logdir = tmp_path / "trace"
    with profile_trace(logdir) as prof:
        with annotate("unit_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "unit_step" for e in events)
    assert any(e.key == "unit_step" for e in prof.key_averages())


def test_disabled_writes_nothing(tmp_path):
    with profile_trace(tmp_path / "off", enabled=False) as prof:
        with annotate("x"):
            pass
    assert prof is None and not (tmp_path / "off").exists()


def test_signature_matches_jax():
    mine, theirs = inspect.signature(profile_trace), inspect.signature(j_profiler.profile_trace)
    assert [(p.name, p.default) for p in mine.parameters.values()] == \
        [(p.name, p.default) for p in theirs.parameters.values()]
