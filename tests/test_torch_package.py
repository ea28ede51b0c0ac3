"""Package hygiene of the PyTorch port.

* importing every module of `latent_diffusion_speech_tpu_torch` and running
  its text frontend loads no JAX, nothing of the JAX package and no yaml;
* no module of the port, and not chip_smoke.py, names jax, flax, optax or
  the JAX package in an import;
* the entry points run on the card unless asked for the CPU;
* each config dataclass the port declares again has the same fields and
  defaults as its JAX counterpart, so the two cannot drift, and both
  `load_config`s read `configs/config.yaml` to the same values;
* every public function and method the port shares by name with the JAX
  package has the same default argument values (dtype defaults, torch
  against jnp, are listed and compared by name).
"""

import dataclasses
import importlib
import inspect
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import latent_diffusion_speech_tpu_torch as port
from latent_diffusion_speech_tpu import config as j_config
from latent_diffusion_speech_tpu.models.diffusion import unet1d as j_unet1d
from latent_diffusion_speech_tpu.models.diffusion import unet1d_condition as j_unet1d_condition
from latent_diffusion_speech_tpu.models import w2vbert as j_w2vbert
from latent_diffusion_speech_tpu.models import wav2vec2 as j_wav2vec2
from latent_diffusion_speech_tpu.models.diffusion import unit2mel as j_unit2mel
from latent_diffusion_speech_tpu.models import bert as j_bert
from latent_diffusion_speech_tpu.models.lm import llama as j_llama
from latent_diffusion_speech_tpu.models.lm import roformer as j_roformer
from latent_diffusion_speech_tpu.models.lm import sampling as j_sampling
from latent_diffusion_speech_tpu.models.vaegan import config as j_vaegan_config
from latent_diffusion_speech_tpu_torch import config
from latent_diffusion_speech_tpu_torch.models import bert, w2vbert, wav2vec2
from latent_diffusion_speech_tpu_torch.models.diffusion import unet1d, unet1d_condition, unit2mel
from latent_diffusion_speech_tpu_torch.models.lm import llama, roformer, sampling
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
    assert {f"{port.__name__}.parallel.{m}" for m in ("dist", "mesh", "multihost", "dryrun")} <= set(MODULES)


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
    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline
    from latent_diffusion_speech_tpu_torch.infer.load import load_native_pipeline, load_reference_pipeline
    from latent_diffusion_speech_tpu_torch.models.units import (
        HubertSoftUnits,
        UnitsEncoder,
        Wav2Vec2BertUnits,
        WhisperLargeV3Units,
        XLSRUnits,
    )
    from latent_diffusion_speech_tpu_torch.models.vaegan.codec import HifiVAEGAN
    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
    from latent_diffusion_speech_tpu_torch.quantize.codebook import EuclideanCodebook
    from latent_diffusion_speech_tpu_torch.train.codec_trainer import CodecTrainer
    from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer

    tiny = unit2mel.Unit2MelConfig(input_channel=8, n_spk=4, out_dims=4, n_hidden=8, block_out_channels=(8, 8),
                                   n_heads=2, timesteps=20, k_step=20)
    from latent_diffusion_speech_tpu_torch.text.bert import NativeBertFeatures

    return {
        "RoformerSystem": lambda: roformer.RoformerSystem(roformer.RoformerConfig()),
        "LlamaSystem": lambda: llama.LlamaSystem(llama.LlamaConfig(moe_experts=2)),
        "NativeBertFeatures": lambda: NativeBertFeatures(cache_dir="no-such-dir"),
        "Unit2MelSystem": lambda: unit2mel.Unit2MelSystem(unit2mel.Unit2MelConfig()),
        "Vocoder": lambda: Vocoder("hifi-vaegan"),
        "HifiVAEGAN": lambda: HifiVAEGAN.random_init(),
        "EuclideanCodebook": lambda: EuclideanCodebook([[0.0, 1.0]]),
        "DiffusionTrainer": lambda: DiffusionTrainer(config.Config(), model_cfg=tiny),
        "LMTrainer": lambda: LMTrainer(config.Config()),
        "CodecTrainer": lambda: CodecTrainer(),
        "build_pipeline": lambda: build_pipeline(config.Config()),
        "load_native_pipeline": lambda: load_native_pipeline(config.Config()),
        "load_reference_pipeline": lambda: load_reference_pipeline("exp/diffusion"),
        "UnitsEncoder": lambda: UnitsEncoder(),
        "WhisperLargeV3Units": lambda: WhisperLargeV3Units(),
        "HubertSoftUnits": lambda: HubertSoftUnits(),
        "XLSRUnits": lambda: XLSRUnits(),
        "Wav2Vec2BertUnits": lambda: Wav2Vec2BertUnits(),
    }


# the CLIs without --device, each on the shipped config
CONFIG = str(PORT_DIR.parent / "configs" / "config.yaml")
CLIS = {
    "cli.infer_svc": ["-c", CONFIG, "-i", "no-such-input.wav"],
    "cli.preprocess_unit": ["-c", CONFIG],
    "cli.preprocess_token": ["-c", CONFIG],
    "cli.preprocess_mel": ["-c", CONFIG],
    "cli.preprocess_cluster": ["-c", CONFIG],
    "cli.preprocess_val": ["-c", CONFIG],
    "cli.train_diffusion": ["-c", CONFIG],
    "cli.train_lm": ["-c", CONFIG],
    "cli.train_codec": ["-c", CONFIG],
    "cli.batch_preprocess": ["-c", CONFIG],
    "cli.verify_import": ["no-such-checkpoint.pt"],
}


@pytest.mark.parametrize("name", ["RoformerSystem", "LlamaSystem", "NativeBertFeatures", "Unit2MelSystem", "Vocoder",
                                  "HifiVAEGAN", "EuclideanCodebook", "DiffusionTrainer", "LMTrainer", "CodecTrainer",
                                  "build_pipeline", "load_native_pipeline",
                                  "load_reference_pipeline", "UnitsEncoder", "WhisperLargeV3Units",
                                  "HubertSoftUnits", "XLSRUnits", "Wav2Vec2BertUnits", *CLIS])
def test_entry_points_default_to_the_card(name):
    """A default-constructed entry point, or a CLI run without --device,
    asks for `cuda`: without a card it raises (never a silent CPU run);
    with one it lands there."""
    import torch

    if name in CLIS:
        if torch.cuda.is_available():
            pytest.skip("runs the whole CLI on the card (chip_smoke.py drives it there)")
        main = importlib.import_module(f"{port.__name__}.{name}").main
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(CLIS[name])
        return
    make = _default_systems()[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    elif name == "load_reference_pipeline":
        with pytest.raises(FileNotFoundError):  # past the device check, no checkpoint to read
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
    "LlamaConfig": (llama.LlamaConfig, j_llama.LlamaConfig),
    "BertConfig": (bert.BertConfig, j_bert.BertConfig),
    "RoformerConfig": (roformer.RoformerConfig, j_roformer.RoformerConfig),
    "SamplingConfig": (sampling.SamplingConfig, j_sampling.SamplingConfig),
    "UNet1DConfig": (unet1d.UNet1DConfig, j_unet1d.UNet1DConfig),
    "UNet1DConditionConfig": (unet1d_condition.UNet1DConditionConfig, j_unet1d_condition.UNet1DConditionConfig),
    "Unit2MelConfig": (unit2mel.Unit2MelConfig, j_unit2mel.Unit2MelConfig),
    "VAEGANConfig": (vaegan_config.VAEGANConfig, j_vaegan_config.VAEGANConfig),
    "Wav2Vec2Config": (wav2vec2.Wav2Vec2Config, j_wav2vec2.Wav2Vec2Config),
    "W2vBertConfig": (w2vbert.W2vBertConfig, j_w2vbert.W2vBertConfig),
    **{name: (getattr(config, name), getattr(j_config, name)) for name in (
        "Config", "DataConfig", "VocoderConfig", "InferConfig", "CommonConfig", "DiffusionModelConfig",
        "TrainConfig", "DiffusionConfig", "TransformerConfig", "LMModelConfig", "LMTrainConfig", "LMConfig",
        "ParallelConfig", "DebugConfig")},
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_config_matches_jax_counterpart(name):
    mine, theirs = PAIRS[name]
    assert _fields(mine) == _fields(theirs)
    assert mine.__dataclass_params__.frozen == theirs.__dataclass_params__.frozen


def test_load_config_matches_jax():
    path = PORT_DIR.parent / "configs" / "config.yaml"
    assert config.config_to_dict(config.load_config(path)) == j_config.config_to_dict(j_config.load_config(path))


# (module of the port, qualified name, parameter): a dtype default, torch's
# against jnp's; compared by the dtype's name
DTYPE_DEFAULTS = {
    ("models.diffusion.unit2mel", "Unit2MelSystem.__init__", "dtype"),
    ("models.lm.roformer", "RoformerSystem.__init__", "dtype"),
    ("models.lm.llama", "LlamaSystem.__init__", "dtype"),
    ("models.units", "WhisperLargeV3Units.__init__", "dtype"),
    ("models.units", "HubertSoftUnits.__init__", "dtype"),
    ("models.units", "XLSRUnits.__init__", "dtype"),
    ("models.units", "Wav2Vec2BertUnits.__init__", "dtype"),
    ("models.vaegan.codec", "HifiVAEGAN.__init__", "dtype"),
    ("models.vaegan.codec", "HifiVAEGAN.random_init", "dtype"),
    ("models.vaegan.codec", "HifiVAEGAN.from_torch_checkpoint", "dtype"),
    ("ops.stft", "hann_window", "dtype"),
    ("ops.weight_quant", "dequantize_tree", "dtype"),
    ("train.diffusion_trainer", "DiffusionTrainer.__init__", "dtype"),
    ("train.lm_trainer", "LMTrainer.__init__", "dtype"),
}


def _shared_callables(mine, theirs):
    """(qualified name, port function, JAX function) for the public functions
    and the methods (and `__init__`) of the public classes defined in the
    port's module whose name the JAX module shares."""
    for attr, obj in vars(mine).items():
        if attr.startswith("_") or getattr(obj, "__module__", None) != mine.__name__:
            continue
        other = getattr(theirs, attr, None)
        if inspect.isfunction(obj) and inspect.isfunction(other):
            yield attr, obj, other
        elif inspect.isclass(obj) and inspect.isclass(other):
            for name, fn in vars(obj).items():
                if name.startswith("_") and name != "__init__":
                    continue
                fn, other_fn = getattr(fn, "__func__", fn), inspect.getattr_static(other, name, None)
                other_fn = getattr(other_fn, "__func__", other_fn)
                if inspect.isfunction(fn) and inspect.isfunction(other_fn):
                    yield f"{attr}.{name}", fn, other_fn


def test_default_arguments_match_jax():
    """The same call gives the same defaults in both packages (a sampler
    default that differed made the same call run another sampler)."""
    compared, mismatched, dtypes = 0, [], set()
    for name in MODULES:
        try:
            theirs = importlib.import_module(name.replace(port.__name__, "latent_diffusion_speech_tpu", 1))
        except ModuleNotFoundError:
            continue  # the port's own modules (kernels, convert)
        short = name[len(port.__name__) + 1:]
        for qual, fn, other in _shared_callables(importlib.import_module(name), theirs):
            mine_p, their_p = inspect.signature(fn).parameters, inspect.signature(other).parameters
            for p, param in mine_p.items():
                a = param.default
                b = their_p[p].default if p in their_p else inspect.Parameter.empty
                if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
                    continue
                compared += 1
                if (short, qual, p) in DTYPE_DEFAULTS:
                    dtypes.add((short, qual, p))
                    assert str(a).removeprefix("torch.") == np.dtype(b).name, (qual, p, a, b)
                elif not (type(a) is type(b) and a == b):
                    mismatched.append((short, qual, p, a, b))
    assert not mismatched
    assert dtypes == DTYPE_DEFAULTS
    assert compared >= 500
