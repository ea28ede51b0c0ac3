"""Typed configuration: nested dataclasses over one YAML file.

A copy of `latent_diffusion_speech_tpu/config.py` (the port imports nothing
of the JAX package): the same dataclasses, fields and defaults
(`tests/test_torch_package.py` holds them to the JAX ones), the same
unknown-key warnings.  `yaml` is imported inside `load_config` /
`save_config` only, so importing the port loads no yaml.  Fields that
select a JAX lowering (`conv_impl`, `attn_impl`, `qkv`, ...) or the device
mesh are read by the JAX package; the port keeps them so one file
configures both.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, List, Optional, Tuple

__all__ = [
    "Config",
    "DataConfig",
    "VocoderConfig",
    "InferConfig",
    "CommonConfig",
    "DiffusionModelConfig",
    "TrainConfig",
    "DiffusionConfig",
    "TransformerConfig",
    "LMModelConfig",
    "LMTrainConfig",
    "LMConfig",
    "ParallelConfig",
    "DebugConfig",
    "load_config",
    "save_config",
    "config_from_dict",
    "config_to_dict",
]


@dataclass
class DataConfig:
    """Audio/data-layout section (reference `configs/config.yaml:1-15`)."""

    acoustic_scale: float = 1.0
    block_size: int = 512            # vocoder hop size (samples per latent frame)
    duration: float = 1.0            # random crop length in seconds for training
    encoder: str = "whisper_large_v3"
    encoder_hop_size: int = 320
    encoder_sample_rate: int = 16000
    extensions: List[str] = field(default_factory=lambda: ["wav"])
    f0_max: float = 1200.0
    f0_min: float = 40.0
    sampling_rate: int = 44100
    units_forced_mode: str = "nearest"   # nearest | rfa441to512 | rfa512to441
    train_path: str = "data/train"
    valid_path: str = "data/val"

    @property
    def frames_per_second(self) -> float:
        return self.sampling_rate / self.block_size


@dataclass
class VocoderConfig:
    """HiFi-VAEGAN codec section (reference `configs/config.yaml:20-24`)."""

    ckpt: str = "pretrain/hifi-vaegan"
    type: str = "hifi-vaegan"
    only_mean: bool = True
    clamp: float = 10.0


@dataclass
class InferConfig:
    method: str = "unipc"      # unipc | dpm-solver | ddim | pndm | ddpm
    speedup: int = 10
    # serve-only weight quantization: None | 'int8' (per-channel, fused
    # dequant in the sampling scan — ops/weight_quant.py)
    weight_quant: str = ""


@dataclass
class CommonConfig:
    n_spk: int = 323
    device: str = "tpu"
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    infer: InferConfig = field(default_factory=InferConfig)


@dataclass
class DiffusionModelConfig:
    """UNet-1D denoiser geometry (reference `configs/config.yaml:30-36`)."""

    block_out_channels: Tuple[int, ...] = (256, 384, 512, 512)
    n_chans: int = 512
    n_heads: int = 8
    n_hidden: int = 256
    n_layers: int = 2
    use_pitch_aug: bool = True
    # Diffusion process (reference `diffusion/diffusion.py:28-30,46-50`)
    timesteps: int = 1000
    k_step_max: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    # Latent geometry: out_dims = vocoder latent channels
    out_dims: int = 128
    # UNet conv lowering: 'xla' (conv_general_dilated) or 'matmul' (shifted
    # matmuls — fwd AND bwd become dot_generals; perf knob, same numerics)
    conv_impl: str = "xla"
    # UNet attention: 'xla' (einsum — measured at its traffic floor here) or
    # 'fused' (opt-in Pallas single-block kernel; loses at these shapes)
    attn_impl: str = "xla"
    # GEGLU gelu: 'auto' (default — tanh approximation iff batch >= 128, the
    # measured crossover in TRAIN_STEP_AB.json: -4% step at B=256, loses at
    # B=64) | 'exact' (erf everywhere, bit-parity mode) | 'tanh' (everywhere)
    gelu: str = "auto"
    # q/k/v projections: 'split' (parity default) | 'fused' (one (C,3C) matmul)
    qkv: str = "split"


@dataclass
class TrainConfig:
    """Shared trainer knobs (reference `configs/config.yaml:37-54,84-103`)."""

    batch_size: int = 48
    cache_all_data: bool = False
    cache_device: str = "cpu"
    clip_grad_norm: float = 1.0
    decay_step: int = 300_000
    epochs: int = 100_000
    expdir: str = "exp/diffusion"
    gamma: float = 0.5
    interval_log: int = 100
    interval_val: int = 5000
    interval_force_save: int = 10_000
    last_save_model_num: int = 4
    lr: float = 1.5e-4
    num_workers: int = 4
    save_opt: bool = False
    start_lr: float = 1e-5
    warm_up_steps: int = 1000
    weight_decay: float = 0.0
    gradient_accumulation_steps: int = 1
    # TPU-native knobs (no reference equivalent)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    seed: int = 0
    ema_decay: float = 0.0  # >0 enables a params EMA for eval/serve
    # device_collate: host ships raw cropped features (mel stats + native-rate
    # units + gather index); latent sampling/alignment/clamp run fused inside
    # the jitted step — ~2x less host work and host->device bytes
    device_collate: bool = False
    # transfer_dtype: narrow the units payload on host (e.g. "bfloat16" —
    # the model casts to bf16 at its first matmul anyway); None ships f32
    transfer_dtype: Optional[str] = None
    # loader_processes: >0 assembles batches in N spawn worker PROCESSES
    # (the counterpart of the reference torch DataLoader `num_workers`,
    # diffusion/data_loaders.py:30-37) — for Python-bound collate stages the
    # 2-thread pool cannot scale past the GIL.  0 keeps the thread prefetcher
    # (right when the C++ batched reader does the heavy lifting).
    loader_processes: int = 0


@dataclass
class DiffusionConfig:
    model: DiffusionModelConfig = field(default_factory=DiffusionModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


@dataclass
class TransformerConfig:
    """RoFormer encoder/decoder geometry (reference `configs/config.yaml:62-83`)."""

    attention_probs_dropout_prob: float = 0.1
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    hidden_size: int = 256
    initializer_range: float = 0.02
    intermediate_size: int = 512
    layer_norm_eps: float = 1e-12
    max_position_embeddings: int = 3072
    num_attention_heads: int = 8
    num_hidden_layers: int = 4


@dataclass
class LMModelConfig:
    codebook_path: str = "pretrain/semantic_codebook.npz"
    mode: str = "phone"              # phone | text
    semantic_kmeans_num: int = 4096
    type: str = "roformer"           # roformer | llama
    # MoE knobs (llama only; 0 = dense FFN).  No reference equivalent — the
    # reference has no MoE models; this feeds the mesh 'expert' axis.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    decoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(num_hidden_layers=1)
    )
    encoder: TransformerConfig = field(default_factory=TransformerConfig)


@dataclass
class LMTrainConfig(TrainConfig):
    batch_size: int = 32
    clip_grad_norm: float = -1.0
    decay_step: int = 20_000
    expdir: str = "exp/lm"
    interval_val: int = 2000
    lr: float = 2e-4
    num_workers: int = 2
    save_opt: bool = True
    units_quantize_type: str = "kmeans"   # kmeans | vq
    use_units_quantize: bool = True
    use_flash_attn: bool = True
    # length_sorted: batch utterances of similar semantic length together
    # (pool-local sort + batch-order shuffle, data/loader.py) so the static
    # pad buckets hug the true lengths — the TPU-side answer to the
    # reference's flash-attn varlen unpadding
    # (text2semantic/roformer/roformer_flash_attn.py:110-169), which removes
    # pad FLOPs via dynamic shapes XLA would retrace on.  Measured in
    # benchmarks/lm_padding_bench.py.
    length_sorted: bool = True


@dataclass
class LMConfig:
    model: LMModelConfig = field(default_factory=LMModelConfig)
    train: LMTrainConfig = field(default_factory=LMTrainConfig)


@dataclass
class DebugConfig:
    """Sanitizer switches (SURVEY.md §5 "race detection / sanitizers" — the
    reference has none; this is the framework's own bar).  All off by default
    (zero overhead); see `train/debug.py` for semantics."""

    debug_nans: bool = False    # jax_debug_nans: raise at the first NaN-producing op
    check_interval: int = 0     # >0: finite-param/loss assertion every N steps
    dump_on_nan: bool = False   # write the offending batch to expdir on failure


@dataclass
class ParallelConfig:
    """Device-mesh layout. No reference equivalent (reference is DDP-only via
    HF accelerate, SURVEY.md section 2.8); here parallelism is declarative."""

    data: int = -1      # -1: all remaining devices on the data axis
    model: int = 1      # tensor-parallel axis size
    seq: int = 1        # sequence/context-parallel axis size
    pipe: int = 1       # pipeline-parallel axis size (GPipe microbatching)
    pipe_microbatches: int = 4  # GPipe microbatches per step when pipe > 1
    expert: int = 1     # expert-parallel axis size (MoE expert sharding)
    dcn_data: int = 1   # data-parallel replicas across slices (DCN)

    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "seq", "model", "pipe", "expert")


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    common: CommonConfig = field(default_factory=CommonConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    text2semantic: LMConfig = field(default_factory=LMConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    debug: DebugConfig = field(default_factory=DebugConfig)


# ---------------------------------------------------------------------------
# dict <-> dataclass conversion with unknown-key warnings
# ---------------------------------------------------------------------------

def _coerce(value: Any, typ: Any) -> Any:
    """Best-effort coercion of YAML scalars into the annotated type."""
    origin = getattr(typ, "__origin__", None)
    if is_dataclass(typ) and isinstance(value, dict):
        return _from_dict(typ, value)
    if origin in (tuple, Tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    if origin in (list, List) and isinstance(value, (list, tuple)):
        return list(value)
    if typ is float and isinstance(value, (int, str)):
        return float(value)
    if typ is int and isinstance(value, float) and value == int(value):
        return int(value)
    return value


def _from_dict(cls: type, d: dict) -> Any:
    known = {f.name: f for f in fields(cls)}
    kwargs = {}
    for key, value in d.items():
        if key not in known:
            warnings.warn(f"config: unknown key {cls.__name__}.{key} ignored", stacklevel=2)
            continue
        kwargs[key] = _coerce(value, known[key].type_resolved if hasattr(known[key], "type_resolved") else _resolve(cls, known[key]))
    return cls(**kwargs)


def _resolve(cls: type, f: dataclasses.Field) -> Any:
    import typing
    hints = typing.get_type_hints(cls)
    return hints.get(f.name, f.type)


def config_from_dict(d: dict) -> Config:
    return _from_dict(Config, d)


def config_to_dict(cfg: Any) -> dict:
    out = {}
    for f in fields(cfg):
        v = getattr(cfg, f.name)
        if is_dataclass(v):
            out[f.name] = config_to_dict(v)
        elif isinstance(v, tuple):
            out[f.name] = list(v)
        else:
            out[f.name] = v
    return out


def load_config(path: str | Path) -> Config:
    import yaml

    with open(path, "r") as fh:
        raw = yaml.safe_load(fh) or {}
    return config_from_dict(raw)


def save_config(cfg: Config, path: str | Path) -> None:
    import yaml

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        yaml.safe_dump(config_to_dict(cfg), fh, sort_keys=False)
