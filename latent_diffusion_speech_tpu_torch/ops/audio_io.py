"""WAV read/write without soundfile/librosa.

Counterpart of the numpy-only side of `latent_diffusion_speech_tpu/ops/audio_io.py`
(the port's own copy): a minimal RIFF WAVE codec, PCM 16/24/32-bit and IEEE
float32, mono or multi-channel; integer data normalised by -int_min, float
data passed through.  `load_audio` resamples through the port's polyphase
resampler (`ops/resample.py`, on the CPU) and decodes other formats
through an `ffmpeg` subprocess when one is on PATH.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["read_wav", "write_wav", "wav_bytes", "wav_stream_header", "pcm16_bytes", "load_audio"]


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Returns (float32 samples in [-1,1] shaped (T,) or (T, C), sample_rate)."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: subformat in fmt ext
        audio_format = 1 if bits in (16, 24, 32) else 3

    if audio_format == 3 and bits == 32:
        samples = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif audio_format == 1 and bits == 16:
        samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        samples = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 1 and bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        ints = (ints << 8) >> 8  # sign-extend 24 -> 32
        samples = ints.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"{path}: unsupported WAV format ({audio_format}, {bits}-bit)")

    if n_channels > 1:
        samples = samples.reshape(-1, n_channels)
    return samples, sample_rate


def pcm16_bytes(samples: np.ndarray) -> bytes:
    """Encode float samples in [-1, 1] as little-endian 16-bit PCM bytes."""
    samples = np.asarray(samples)
    return np.round(np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def wav_stream_header(sample_rate: int, n_channels: int = 1) -> bytes:
    """RIFF/WAVE header for a PCM-16 stream of unknown length.

    The RIFF and data sizes are set to 0xFFFFFFFF (the de-facto streaming
    convention); players read PCM until EOF.  Follow with `pcm16_bytes`
    payloads — e.g. as HTTP chunked-transfer chunks."""
    byte_rate = sample_rate * n_channels * 2
    fmt_chunk = struct.pack("<HHIIHH", 1, n_channels, sample_rate, byte_rate, n_channels * 2, 16)
    return b"".join(
        [
            b"RIFF",
            struct.pack("<I", 0xFFFFFFFF),
            b"WAVE",
            b"fmt ",
            struct.pack("<I", len(fmt_chunk)),
            fmt_chunk,
            b"data",
            struct.pack("<I", 0xFFFFFFFF),
        ]
    )


def wav_bytes(samples: np.ndarray, sample_rate: int, subtype: str = "pcm16") -> bytes:
    """Encode samples as a RIFF/WAVE byte string (for files or HTTP bodies)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    n_channels = samples.shape[1]

    if subtype == "pcm16":
        body = pcm16_bytes(samples)
        bits, audio_format = 16, 1
    elif subtype == "float32":
        body = samples.astype("<f4").tobytes()
        bits, audio_format = 32, 3
    else:
        raise ValueError(f"unsupported subtype {subtype!r}")

    byte_rate = sample_rate * n_channels * bits // 8
    block_align = n_channels * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", audio_format, n_channels, sample_rate, byte_rate, block_align, bits)
    return b"".join(
        [
            b"RIFF",
            struct.pack("<I", 4 + 8 + len(fmt_chunk) + 8 + len(body)),
            b"WAVE",
            b"fmt ",
            struct.pack("<I", len(fmt_chunk)),
            fmt_chunk,
            b"data",
            struct.pack("<I", len(body)),
            body,
        ]
    )


def write_wav(path: str | Path, samples: np.ndarray, sample_rate: int, subtype: str = "pcm16") -> None:
    Path(path).write_bytes(wav_bytes(samples, sample_rate, subtype))


def _ffmpeg_decode(path: str | Path, sample_rate: int) -> np.ndarray:
    """Decode any ffmpeg-supported format to mono float32 at `sample_rate`
    (the reference whisper loader's subprocess pipeline, `whisper/audio.py:15-32`)."""
    import subprocess

    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", str(path),
        "-f", "f32le", "-ac", "1", "-acodec", "pcm_f32le",
        "-ar", str(sample_rate), "-",
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"ffmpeg failed to decode {path}: {e.stderr.decode(errors='replace')[-500:]}"
        ) from None
    return np.frombuffer(out, np.float32).copy()


def load_audio(
    path: str | Path, target_sr: int | None = None, mono: bool = True
) -> Tuple[np.ndarray, int]:
    """Load + normalize (+ optionally resample via the polyphase resampler).
    Mirrors the load path of `nvSTFT.load_wav_to_torch` (`nvSTFT.py:11-41`).

    Non-WAV formats (mp3/flac/ogg/...) decode through ffmpeg when the binary
    is on PATH — the reference's own non-WAV path (`whisper/audio.py:15-32`);
    without ffmpeg they raise with that guidance."""
    try:
        samples, sr = read_wav(path)
    except ValueError:
        import shutil

        if shutil.which("ffmpeg") is None:
            raise ValueError(
                f"{path}: not a RIFF/WAVE file and no `ffmpeg` on PATH to "
                "decode other formats (the reference uses the same ffmpeg "
                "subprocess for non-WAV inputs)"
            ) from None
        sr = target_sr or 44100
        return _ffmpeg_decode(path, sr), sr
    if mono and samples.ndim > 1:
        samples = samples[:, 0]
    if target_sr is not None and sr != target_sr:
        import torch

        from latent_diffusion_speech_tpu_torch.ops.resample import resample

        samples = resample(torch.from_numpy(np.ascontiguousarray(samples, np.float32)), sr, target_sr).numpy()
        sr = target_sr
    return samples.astype(np.float32), sr
