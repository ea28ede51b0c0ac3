"""No module of JAX, flax or the JAX package is loaded by the harness, by
whole top-level name: the port's name begins with the package's."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

from lds_bench import manifest
from lds_bench.run import FORBIDDEN, forbidden_modules

ROOT = manifest.ROOT


def test_whole_names_only(monkeypatch):
    monkeypatch.setitem(sys.modules, "latent_diffusion_speech_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "latent_diffusion_speech_tpu_torch_fake" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in forbidden_modules()
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "latent_diffusion_speech_tpu"}


def test_a_tiny_cpu_run_loads_none():
    """A whole run, the program and the reference included, at tiny widths
    on the CPU, in a fresh process."""
    code = (
        "import json, sys, torch\n"
        "from lds_bench import manifest, run\n"
        "from lds_bench.tests import tiny\n"
        "b = manifest.load()\n"
        "r = run.run_cell(tiny.config('general'), tiny.traffic('b32'), manifest.end_to_end(b, 'general.b32'),\n"
        "                 manifest.per_layer(b, 'general.b32'), 9, 0.5, True, torch.device('cpu'))\n"
        "print(json.dumps({'correct': r['correct'], 'found': run.forbidden_modules(),\n"
        "                  'port': 'latent_diffusion_speech_tpu_torch' in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "found": [], "port": True}


def test_no_harness_source_imports_them():
    for path in manifest.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] in FORBIDDEN for n in names), (path, names)


def test_without_the_program_the_run_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and lds_bench/ prints no
    result and exits non-zero."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "lds_bench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = subprocess.run([sys.executable, "-m", "lds_bench.run", "--workload", "flagship.solo", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert not Path(tmp_path / "latent_diffusion_speech_tpu_torch").exists()
