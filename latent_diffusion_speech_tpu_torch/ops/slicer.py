"""RMS silence slicer for long-audio streaming inference (host-side numpy).

Capability-parity with the reference slicer (`tools/slicer.py:6-165`): detect
silent stretches by frame RMS against a dB threshold, keep at most
`max_sil_kept` frames of silence around cut points, and emit
(start_frame, voiced_segment) pairs for per-segment synthesis + stitching.
A copy of `latent_diffusion_speech_tpu/ops/slicer.py` (numpy only): it runs
on the host and gates what reaches the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

__all__ = ["Slicer", "split_voiced"]


def _frame_rms(y: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    """Centered frame RMS (librosa.feature.rms semantics: zero pad
    frame_length//2 each side, power mean, sqrt)."""
    pad = frame_length // 2
    y2 = np.pad(y.astype(np.float64) ** 2, (pad, pad))
    n_frames = 1 + (len(y2) - frame_length) // hop
    # cumulative-sum trick: mean of y2 over each window
    csum = np.concatenate([[0.0], np.cumsum(y2)])
    starts = np.arange(n_frames) * hop
    window_sums = csum[starts + frame_length] - csum[starts]
    return np.sqrt(window_sums / frame_length)


@dataclass(frozen=True)
class Segment:
    voiced: bool
    start: int   # sample index
    end: int     # sample index (exclusive)


class Slicer:
    def __init__(
        self,
        sr: int,
        threshold_db: float = -40.0,
        min_length_ms: int = 5000,
        min_interval_ms: int = 300,
        hop_ms: int = 20,
        max_sil_kept_ms: int = 5000,
    ):
        if not min_length_ms >= min_interval_ms >= hop_ms:
            raise ValueError("need min_length >= min_interval >= hop")
        if not max_sil_kept_ms >= hop_ms:
            raise ValueError("need max_sil_kept >= hop")
        interval_samples = sr * min_interval_ms / 1000
        self.threshold = 10.0 ** (threshold_db / 20.0)
        self.hop = round(sr * hop_ms / 1000)
        self.win = min(round(interval_samples), 4 * self.hop)
        self.min_length = round(sr * min_length_ms / 1000 / self.hop)     # frames
        self.min_interval = round(interval_samples / self.hop)            # frames
        self.max_sil_kept = round(sr * max_sil_kept_ms / 1000 / self.hop) # frames

    def _silence_tags(self, rms: np.ndarray) -> List[Tuple[int, int]]:
        """Scan for (cut_start, cut_end) frame ranges of removable silence."""
        tags: List[Tuple[int, int]] = []
        sil_start = None
        clip_start = 0
        K = self.max_sil_kept
        for i, v in enumerate(rms):
            if v < self.threshold:
                if sil_start is None:
                    sil_start = i
                continue
            if sil_start is None:
                continue
            leading = sil_start == 0 and i > K
            middle = i - sil_start >= self.min_interval and i - clip_start >= self.min_length
            if not leading and not middle:
                sil_start = None
                continue
            dur = i - sil_start
            if dur <= K:
                pos = int(rms[sil_start : i + 1].argmin()) + sil_start
                tags.append((0, pos) if sil_start == 0 else (pos, pos))
                clip_start = pos
            elif dur <= 2 * K:
                pos = int(rms[i - K : sil_start + K + 1].argmin()) + i - K
                pos_l = int(rms[sil_start : sil_start + K + 1].argmin()) + sil_start
                pos_r = int(rms[i - K : i + 1].argmin()) + i - K
                if sil_start == 0:
                    tags.append((0, pos_r))
                    clip_start = pos_r
                else:
                    tags.append((min(pos_l, pos), max(pos_r, pos)))
                    clip_start = max(pos_r, pos)
            else:
                pos_l = int(rms[sil_start : sil_start + K + 1].argmin()) + sil_start
                pos_r = int(rms[i - K : i + 1].argmin()) + i - K
                tags.append((0, pos_r) if sil_start == 0 else (pos_l, pos_r))
                clip_start = pos_r
            sil_start = None
        n = len(rms)
        if sil_start is not None and n - sil_start >= self.min_interval:
            sil_end = min(n, sil_start + K)
            pos = int(rms[sil_start : sil_end + 1].argmin()) + sil_start
            tags.append((pos, n + 1))
        return tags

    def slice(self, audio: np.ndarray) -> List[Segment]:
        """Segment mono audio into alternating voiced / silence spans."""
        if audio.ndim > 1:
            audio = audio.mean(axis=0)
        n = len(audio)
        if n <= self.min_length:
            return [Segment(True, 0, n)]
        rms = _frame_rms(audio, self.win, self.hop)
        tags = self._silence_tags(rms)
        if not tags:
            return [Segment(True, 0, n)]

        segs: List[Segment] = []
        h = self.hop
        if tags[0][0] > 0:
            segs.append(Segment(True, 0, min(n, tags[0][0] * h)))
        for i, (s, e) in enumerate(tags):
            if i:
                prev_end = tags[i - 1][1]
                segs.append(Segment(True, prev_end * h, min(n, s * h)))
            segs.append(Segment(False, s * h, min(n, e * h)))
        if tags[-1][1] * h < n:
            segs.append(Segment(True, tags[-1][1] * h, n))
        return [s for s in segs if s.end > s.start]


def split_voiced(
    audio: np.ndarray,
    sample_rate: int,
    hop_size: int,
    threshold_db: float = -40.0,
    min_length_ms: int = 5000,
) -> List[Tuple[int, np.ndarray]]:
    """(start_latent_frame, voiced_audio) pairs, frame-aligned to `hop_size`
    (reference `tools/slicer.py:149-165`)."""
    slicer = Slicer(sample_rate, threshold_db=threshold_db, min_length_ms=min_length_ms)
    out = []
    for seg in slicer.slice(audio):
        if not seg.voiced:
            continue
        start_frame = seg.start // hop_size
        end_frame = seg.end // hop_size
        if end_frame > start_frame:
            out.append((int(start_frame), audio[start_frame * hop_size : end_frame * hop_size]))
    return out
