"""Semantic unit extraction (the reference's `Units_Encoder`, tools/tools.py:43-103).

Counterpart of `latent_diffusion_speech_tpu/models/units.py`: the encoder
registry, input resampling to the encoder rate, the 400-sample minimum,
the rate-forcing modes and the half-second bucket padding.  Whisper-large-v3
is ported; HuBERT-soft, w2v-BERT 2.0 and XLSR-53 are not yet (ROADMAP.md
Queue 1, item 6) and raise `NotImplementedError`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from latent_diffusion_speech_tpu_torch.models.whisper.model import WhisperDims, WhisperEncoder
from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype, init_weights, resolve_device
from latent_diffusion_speech_tpu_torch.ops.resample import resample
from latent_diffusion_speech_tpu_torch.ops.stft import whisper_log_mel

__all__ = ["ENCODER_OUT_CHANNELS", "get_encoder_out_channels", "WhisperLargeV3Units", "UnitsEncoder",
           "whisper_state_from_reference"]

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
        """kw goes to the encoder (`WhisperLargeV3Units`: dims, dtype, seed,
        device)."""
        self.encoder = encoder
        if encoder == "whisper_large_v3":
            self.model = WhisperLargeV3Units(ckpt_path=ckpt_path, **kw)
        elif encoder in ("hubert_soft", "w2v-bert", "xlsr_53_56k"):
            raise NotImplementedError(
                f"units encoder {encoder!r} is not ported yet (ROADMAP.md Queue 1, item 6); "
                "whisper_large_v3 is")
        else:
            raise ValueError(f"[x] Unknown units encoder: {encoder}")
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
