"""BENCHMARK.json against the benchmark's contract, and the discovery of
configurations, traffic mixes and metrics by name alone."""

import json
import re
import shutil

import pytest

from lds_bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lds_bench"]
    assert len(BENCH["command"]) <= 32 and all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_keys_and_names(section, keys):
    names = [e["name"] for e in BENCH[section]]
    assert len(set(names)) == len(names)
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_cells_configs_and_metrics_agree():
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert {w["config"] for w in cells.values()} == set(configs)
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert all(w["chips"] in (1, 4) for w in cells.values())
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    layers = set()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert manifest.workload(BENCH, cell)["name"] == cell
            assert m["moves"] in {x["name"] for x in manifest.end_to_end(BENCH, cell)}
        layers.add(m["layer"])
    for cell in cells:
        reported = {m["name"] for m in manifest.end_to_end(BENCH, cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.per_layer(BENCH, cell)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_exist_under_paths(cfg):
    assert cfg["file"] == f"lds_bench/configs/{cfg['name']}.json"
    data = manifest.config(cfg["name"])
    assert not cfg["reduced"] and data["source"] == cfg["source"]


def test_every_named_file_exists():
    for w in BENCH["workloads"]:
        manifest.config(w["config"])
        manifest.traffic(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]).read)


def test_a_new_cell_is_found_by_name(tmp_path):
    """A later change adds a configuration, a traffic mix and a metric as new
    files and entries; the harness finds them without an edit."""
    here = tmp_path / "lds_bench"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = manifest.config("flagship")
    cfg["program"]["attn_impl"] = "pallas"
    (here / "configs" / "flagship_k5.json").write_text(json.dumps(cfg))
    tr = manifest.traffic("solo")
    tr["lengths"]["median_frames"] = 200
    (here / "traffic" / "short.json").write_text(json.dumps(tr))
    (here / "metrics" / "calls_per_s.py").write_text("def read(run):\n    return len(run.calls) / run.window_s\n")
    (here / "metrics" / "audio_s_per_s.short.py").write_text(
        "from lds_bench import manifest\n\nread = manifest.metric_reader('audio_s_per_s').read\n")
    bench["configs"].append(dict(BENCH["configs"][0], name="flagship_k5", file="lds_bench/configs/flagship_k5.json"))
    bench["workloads"].append({"name": "flagship_k5.short", "config": "flagship_k5", "traffic": "short", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                               "layer": "pipeline", "moves": "audio_s_per_s.short", "workloads": ["flagship_k5.short"]})
    bench["end_to_end"].append({"name": "audio_s_per_s.short", "unit": "s/s", "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["flagship_k5.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = manifest.load(tmp_path)
    cell = manifest.workload(loaded, "flagship_k5.short")
    assert manifest.config(cell["config"], here)["program"]["attn_impl"] == "pallas"
    assert manifest.traffic(cell["traffic"], here)["lengths"]["median_frames"] == 200
    names = [m["name"] for m in manifest.per_layer(loaded, "flagship_k5.short")]
    assert names == ["calls_per_s"]
    assert "calls_per_s" not in [m["name"] for m in manifest.per_layer(loaded, "general.b32")]
    assert [m["name"] for m in manifest.end_to_end(loaded, "flagship_k5.short")] == ["setup_s", "audio_s_per_s.short"]
    reader = manifest.metric_reader("calls_per_s", here)

    class Run:
        calls, window_s = [1, 2, 3], 2.0
        served = [type("Call", (), {"audio_s": 3.0})] * 2

    assert reader.read(Run) == 1.5
    assert manifest.metric_reader("audio_s_per_s.short", here).read(Run) == 3.0
