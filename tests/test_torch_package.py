"""Package hygiene of the PyTorch port.

* importing every module of `latent_diffusion_speech_tpu_torch` loads no JAX;
* no module of the port names jax, flax or optax in an import;
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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    root = str(PORT_DIR.parent)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(MODULES) >= 15


def test_no_jax_imports_in_the_source():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", re.M)
    # `_build/` holds kernel build outputs (gitignored), not the port's source
    sources = [p for p in PORT_DIR.rglob("*.py") if "_build" not in p.relative_to(PORT_DIR).parts]
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert len(sources) >= 15
    assert not offenders


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
