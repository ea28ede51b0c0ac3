"""Package hygiene of the PyTorch port.

* importing every module of `latent_diffusion_speech_tpu_torch` and running
  its text frontend loads no JAX, nothing of the JAX package and no yaml;
* no module of the port, and not chip_smoke.py, names jax, flax, optax or
  the JAX package in an import;
* the entry points run on the card unless asked for the CPU;
* each config dataclass the port declares again has the same fields and
  defaults as its JAX counterpart, so the two cannot drift.
"""

import dataclasses
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import latent_diffusion_speech_tpu_torch as port
from latent_diffusion_speech_tpu.models.diffusion import unet1d as j_unet1d
from latent_diffusion_speech_tpu.models.diffusion import unit2mel as j_unit2mel
from latent_diffusion_speech_tpu.models.lm import roformer as j_roformer
from latent_diffusion_speech_tpu.models.lm import sampling as j_sampling
from latent_diffusion_speech_tpu.models.vaegan import config as j_vaegan_config
from latent_diffusion_speech_tpu_torch.models.diffusion import unet1d, unit2mel
from latent_diffusion_speech_tpu_torch.models.lm import roformer, sampling
from latent_diffusion_speech_tpu_torch.models.vaegan import config as vaegan_config

PORT_DIR = Path(port.__file__).parent
MODULES = sorted(
    m.name for m in pkgutil.walk_packages([str(PORT_DIR)], prefix="latent_diffusion_speech_tpu_torch.")
)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline\n"
        "phones, tones = TTSPipeline.text_to_phones(None, 'Hello world, this is a test.', 'EN')\n"
        "assert len(phones) == len(tones) > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'latent_diffusion_speech_tpu', 'yaml'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    root = str(PORT_DIR.parent)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(MODULES) >= 15


def test_no_jax_imports_in_the_source():
    # `latent_diffusion_speech_tpu` followed by a word boundary that is not
    # `_`: the JAX package, not the port (`latent_diffusion_speech_tpu_torch`)
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|latent_diffusion_speech_tpu(?![\w]))", re.M
    )
    # `_build/` holds kernel build outputs (gitignored), not the port's source
    sources = [p for p in PORT_DIR.rglob("*.py") if "_build" not in p.relative_to(PORT_DIR).parts]
    sources.append(PORT_DIR.parent / "chip_smoke.py")
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert len(sources) >= 15
    assert not offenders
    assert pattern.search("from latent_diffusion_speech_tpu.text import symbols\n")
    assert not pattern.search("from latent_diffusion_speech_tpu_torch.text import symbols\n")


def _default_systems():
    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
    from latent_diffusion_speech_tpu_torch.quantize.codebook import EuclideanCodebook

    return {
        "RoformerSystem": lambda: roformer.RoformerSystem(roformer.RoformerConfig()),
        "Unit2MelSystem": lambda: unit2mel.Unit2MelSystem(unit2mel.Unit2MelConfig()),
        "Vocoder": lambda: Vocoder("hifi-vaegan"),
        "EuclideanCodebook": lambda: EuclideanCodebook([[0.0, 1.0]]),
    }


@pytest.mark.parametrize("name", ["RoformerSystem", "Unit2MelSystem", "Vocoder", "EuclideanCodebook"])
def test_entry_points_default_to_the_card(name):
    """A default-constructed entry point asks for `cuda`: without a card it
    raises (never a silent CPU run); with one it lands there."""
    import torch

    make = _default_systems()[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    else:
        obj = make()
        device = obj.codebook.device if name == "EuclideanCodebook" else obj.device
        assert device.type == "cuda"


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        else:
            default = dataclasses.MISSING
        out[f.name] = dataclasses.asdict(default) if dataclasses.is_dataclass(default) else default
    return out


PAIRS = {
    "StackConfig": (roformer.StackConfig, j_roformer.StackConfig),
    "RoformerConfig": (roformer.RoformerConfig, j_roformer.RoformerConfig),
    "SamplingConfig": (sampling.SamplingConfig, j_sampling.SamplingConfig),
    "UNet1DConfig": (unet1d.UNet1DConfig, j_unet1d.UNet1DConfig),
    "Unit2MelConfig": (unit2mel.Unit2MelConfig, j_unit2mel.Unit2MelConfig),
    "VAEGANConfig": (vaegan_config.VAEGANConfig, j_vaegan_config.VAEGANConfig),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_config_matches_jax_counterpart(name):
    mine, theirs = PAIRS[name]
    assert _fields(mine) == _fields(theirs)
    assert mine.__dataclass_params__.frozen == theirs.__dataclass_params__.frozen
