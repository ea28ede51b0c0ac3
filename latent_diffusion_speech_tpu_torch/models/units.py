"""Semantic unit extraction (the reference's `Units_Encoder`, tools/tools.py:43-103).

Counterpart of `latent_diffusion_speech_tpu/models/units.py`: the encoder
registry, input resampling to the encoder rate, the 400-sample minimum,
the rate-forcing modes and the half-second bucket padding, over the four
encoders the JAX package offers: Whisper-large-v3 (1280-d), HuBERT-soft
(256-d, `models/hubert.py`), XLSR-53 (1024-d, `models/wav2vec2.py`) and
w2v-BERT 2.0 (1024-d, `models/w2vbert.py`), each at 50 fps.  Each encoder
is built on its device (`device=`, None meaning `cuda`) from a checkpoint,
an injected HF model (`hf_model=`, of which only `.config` and
`.state_dict()` are read) or, when there is neither, seeded (`seed=`) at
full width with flax's initialisers (`ops/layers.py::init_weights`), as the
JAX package seeds it; `dtype=` is the compute dtype of its products.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from latent_diffusion_speech_tpu_torch.models.hubert import HubertSoft, hubert_state_from_torch
from latent_diffusion_speech_tpu_torch.models.w2vbert import (
    W2vBertConfig,
    W2vBertModel,
    w2vbert_fbank,
    w2vbert_state_from_torch,
)
from latent_diffusion_speech_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder, wav2vec2_state_from_torch
from latent_diffusion_speech_tpu_torch.models.whisper.model import WhisperDims, WhisperEncoder
from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype, init_weights, resolve_device
from latent_diffusion_speech_tpu_torch.ops.resample import resample
from latent_diffusion_speech_tpu_torch.ops.stft import whisper_log_mel

__all__ = ["ENCODER_OUT_CHANNELS", "get_encoder_out_channels", "WhisperLargeV3Units", "HubertSoftUnits",
           "XLSRUnits", "Wav2Vec2BertUnits", "UnitsEncoder", "whisper_state_from_reference"]

ENCODER_OUT_CHANNELS = {
    "whisper_large_v3": 1280,
    "w2v-bert": 1024,
    "xlsr_53_56k": 1024,
    "hubert_soft": 256,
}


def get_encoder_out_channels(encoder: str) -> int:
    """Reference `get_encdoer_out_channels` (tools/tools.py:257+)."""
    if encoder not in ENCODER_OUT_CHANNELS:
        raise ValueError(f"[x] Unknown units encoder: {encoder}")
    return ENCODER_OUT_CHANNELS[encoder]


def whisper_state_from_reference(state: dict) -> dict:
    """A reference AudioEncoder state dict (keys `encoder.*` or bare) as
    `WhisperEncoder`'s: the prefix stripped, the `positional_embedding`
    buffer dropped (the encoder computes its sinusoids at the input length,
    as the JAX importer does)."""
    state = {(k[len("encoder."):] if k.startswith("encoder.") else k): v for k, v in state.items()}
    state.pop("positional_embedding", None)
    return state


class WhisperLargeV3Units:
    """Whisper-large-v3 encoder as the unit extractor (ref tools/tools.py:105-126):
    16 kHz audio -> log-mel(128) -> encoder -> (T // 320) frames of 1280-d
    units, f32.

    ckpt_path: the reference checkpoint `{"dims", "model_state_dict"}`
    (`pretrain/large-v3_encoder.pt`); when it does not exist the weights
    are seeded (`dims`, default large-v3) on the device itself.  device:
    None means `cuda` (raises without a card)."""

    def __init__(self, ckpt_path: Optional[str] = None, dims: Optional[WhisperDims] = None,
                 dtype=torch.bfloat16, seed: int = 0, device=None):
        self.device = resolve_device(device)
        ck = None
        if ckpt_path and Path(ckpt_path).exists():
            ck = torch.load(ckpt_path, map_location="cpu", weights_only=False)
            self.dims = WhisperDims.from_checkpoint_dims(ck["dims"])
        else:
            print(f"[!] no Whisper checkpoint at {ckpt_path}; seeded random weights")
            self.dims = dims or WhisperDims()
        with torch.device("meta"):  # no CPU init of ~635 M parameters
            model = WhisperEncoder(self.dims)
        model = model.to_empty(device=self.device)
        if ck is not None:
            model.load_state_dict(whisper_state_from_reference(ck["model_state_dict"]))
        else:
            init_weights(model, torch.Generator(device=self.device).manual_seed(seed))
        self.model = cast_compute_dtype(model, dtype).eval()

    @torch.no_grad()
    def __call__(self, audio16k: torch.Tensor) -> torch.Tensor:
        """(B, T) 16 kHz float audio -> (B, T // 320, n_state) units."""
        if audio16k.dim() == 1:
            audio16k = audio16k[None]
        return self.model(whisper_log_mel(audio16k, n_mels=self.dims.n_mels))


def _built(factory, device: torch.device, state: Optional[dict], seed: int, dtype) -> torch.nn.Module:
    """The module of `factory` on `device` (no CPU init of its weights):
    `state` loaded, or seeded with flax's initialisers; products cast to
    `dtype`; in eval mode."""
    with torch.device("meta"):
        model = factory()
    model = model.to_empty(device=device)
    if state is not None:
        model.load_state_dict(state)
    else:
        g = torch.Generator(device=device).manual_seed(seed)
        init_weights(model, g)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name == "masked_spec_embed":  # flax uniform(1.0)
                    p.uniform_(0.0, 1.0, generator=g)
                elif name.endswith("distance_embedding"):  # flax normal(0.02)
                    p.normal_(0.0, 0.02, generator=g)
    return cast_compute_dtype(model, dtype).eval()


def _load(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=False)


class HubertSoftUnits:
    """HuBERT-soft unit extractor (the reference's alternative encoder,
    `encoder/hubert/model.py:72-80`): 16 kHz audio -> 50 fps 256-d units in
    the compute dtype.  ckpt_path: bshall's release (a `hubert` or `model`
    key, or the bare state dict); seeded when it does not exist."""

    def __init__(self, ckpt_path: Optional[str] = None, dtype=torch.bfloat16, seed: int = 0, device=None):
        self.device = resolve_device(device)
        state = None
        if ckpt_path and Path(ckpt_path).exists():
            ck = _load(ckpt_path)
            state = hubert_state_from_torch(ck.get("hubert", ck.get("model", ck)))
        else:
            print(f"[!] no HuBERT-soft checkpoint at {ckpt_path}; seeded random weights")
        self.model = _built(HubertSoft, self.device, state, seed, dtype)

    @torch.no_grad()
    def __call__(self, audio16k: torch.Tensor) -> torch.Tensor:
        if audio16k.dim() == 1:
            audio16k = audio16k[None]
        return self.model.units(audio16k)


class Wav2Vec2BertUnits:
    """w2v-BERT 2.0 units (ref `tools/tools.py:128-142`): the Kaldi fbank in
    f32, then the conformer: 50 fps 1024-d f32 hidden states.  Weights
    from `hf_model`, else `ckpt_path` (an HF `Wav2Vec2BertModel` state dict,
    or one under a `model` key), else HF's local cache of
    facebook/w2v-bert-2.0 under `cache_dir` (transformers is imported only
    there), else seeded at full width."""

    def __init__(self, ckpt_path: Optional[str] = None, cache_dir: str = "pretrain", dtype=torch.bfloat16,
                 seed: int = 0, hf_model=None, device=None, **_):
        self.device = resolve_device(device)
        self.cfg, state = W2vBertConfig(), None
        if hf_model is not None:
            self.cfg = W2vBertConfig.from_hf(hf_model.config)
            state = hf_model.state_dict()
        elif ckpt_path and Path(ckpt_path).exists():
            ck = _load(ckpt_path)
            state = ck.get("model", ck)
        else:
            try:
                from transformers import Wav2Vec2BertModel as _HF

                hf = _HF.from_pretrained("facebook/w2v-bert-2.0", cache_dir=cache_dir, local_files_only=True)
                self.cfg, state = W2vBertConfig.from_hf(hf.config), hf.state_dict()
            except (ImportError, OSError, ValueError) as e:
                print(f"[!] no local w2v-BERT 2.0 weights ({type(e).__name__}); seeded random weights")
        if state is not None:
            state = w2vbert_state_from_torch(state, self.cfg)
        cfg = self.cfg
        self.model = _built(lambda: W2vBertModel(cfg), self.device, state, seed, dtype)

    @torch.no_grad()
    def __call__(self, audio16k: torch.Tensor) -> torch.Tensor:
        if audio16k.dim() == 1:
            audio16k = audio16k[None]
        return self.model(w2vbert_fbank(audio16k))


class XLSRUnits:
    """XLSR-53 (wav2vec 2.0 large) units (ref `tools/tools.py:144-163`):
    50 fps 1024-d f32 hidden states.  Weights from `hf_model` (an HF
    `Wav2Vec2Model`), else `ckpt_path` (fairseq's `xlsr_53_56k.pt`, told
    apart by `post_extract_proj`, or an HF state dict), else seeded."""

    def __init__(self, ckpt_path: Optional[str] = None, dtype=torch.bfloat16, seed: int = 0, hf_model=None,
                 device=None, **_):
        self.device = resolve_device(device)
        self.cfg, state = Wav2Vec2Config(), None
        if hf_model is not None:
            self.cfg = Wav2Vec2Config.from_hf(hf_model.config)
            state = wav2vec2_state_from_torch(hf_model.state_dict(), self.cfg)
        elif ckpt_path and Path(ckpt_path).exists():
            ck = _load(ckpt_path)
            state = wav2vec2_state_from_torch(ck.get("model", ck), self.cfg)
        else:
            print(f"[!] no XLSR-53 checkpoint at {ckpt_path}; seeded random weights")
        cfg = self.cfg
        self.model = _built(lambda: Wav2Vec2Encoder(cfg), self.device, state, seed, dtype)

    @torch.no_grad()
    def __call__(self, audio16k: torch.Tensor) -> torch.Tensor:
        if audio16k.dim() == 1:
            audio16k = audio16k[None]
        return self.model(audio16k)


_ENCODERS = {"whisper_large_v3": WhisperLargeV3Units, "hubert_soft": HubertSoftUnits,
             "w2v-bert": Wav2Vec2BertUnits, "xlsr_53_56k": XLSRUnits}


class UnitsEncoder:
    def __init__(
        self,
        encoder: str = "whisper_large_v3",
        encoder_sample_rate: int = 16000,
        encoder_hop_size: int = 320,
        units_forced_mode: str = "nearest",
        ckpt_path: Optional[str] = None,
        **kw,
    ):
        """kw goes to the encoder (dtype, seed, device; `WhisperLargeV3Units`:
        dims; XLSR and w2v-BERT: hf_model)."""
        self.encoder = encoder
        if encoder not in _ENCODERS:
            raise ValueError(f"[x] Unknown units encoder: {encoder}")
        self.model = _ENCODERS[encoder](ckpt_path=ckpt_path, **kw)
        self.device = self.model.device

        self.units_forced_mode = units_forced_mode or "left"
        # rate-forcing modes resample to a slightly detuned encoder rate so the
        # unit frame grid lands exactly on the 44.1k/512 latent grid
        # (ref tools/tools.py:67-70)
        if units_forced_mode == "rfa512to441":
            encoder_sample_rate = encoder_sample_rate * 441 // 512
        if units_forced_mode == "rfa441to512":
            encoder_sample_rate = encoder_sample_rate * 512 // 441
        self.encoder_sample_rate = encoder_sample_rate
        self.encoder_hop_size = encoder_hop_size

    @torch.no_grad()
    def encode(self, audio, sample_rate: int, pad_to_bucket: bool = True) -> torch.Tensor:
        """Audio (B, T) or (T,) at `sample_rate` (a tensor or an array) ->
        units (B, T_units, C) on the encoder's device.

        The resampled input is padded with zeros to a half-second bucket
        before the encoder (as the JAX package pads it, so attention sees
        the same frames) and the units are cropped to T // hop."""
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if audio.dim() == 1:
            audio = audio[None]
        if sample_rate != self.encoder_sample_rate:
            audio = resample(audio, sample_rate, self.encoder_sample_rate)
        if audio.shape[-1] < 400:  # ref tools/tools.py:96-97
            audio = F.pad(audio, (0, 400 - audio.shape[-1]))
        T = audio.shape[-1]
        true_frames = T // self.encoder_hop_size
        if pad_to_bucket:
            step = self.encoder_sample_rate // 2
            padded = max(step, ((T + step - 1) // step) * step)
            if padded != T:
                audio = F.pad(audio, (0, padded - T))
        return self.model(audio)[:, :true_frames]
