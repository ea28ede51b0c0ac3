"""Stages 00-02: duration filter, speaker renumbering, validation split.

Counterpart of `latent_diffusion_speech_tpu/cli/prepare_audio.py` (the
reference's `00_del_audio_over_30s.py`, `01_rename_to_increasing_number.py`
and `02_randomly_extract_valset.py` in one tool).  Host only (no torch):

    python -m latent_diffusion_speech_tpu_torch.cli.prepare_audio data/train/audio \\
        --max-sec 30 --renumber --valset data/val/audio [--seed 0]

The validation files are drawn with the standard library's
`random.Random(seed)`, as in JAX, so one seed moves the same files.
"""

from __future__ import annotations

import argparse
import random
import shutil
from pathlib import Path
from typing import Optional, Sequence

from latent_diffusion_speech_tpu_torch.ops.audio_io import read_wav

__all__ = ["drop_long_audio", "renumber_speakers", "extract_valset", "main"]


def drop_long_audio(root: Path, max_sec: float) -> int:
    """Delete wavs >= max_sec and their .txt labels (ref 00_:13-24)."""
    n = 0
    for wav in sorted(root.rglob("*.wav")):
        try:
            samples, sr = read_wav(wav)
        except ValueError:
            continue
        if len(samples) / sr >= max_sec:
            wav.unlink()
            wav.with_suffix(".txt").unlink(missing_ok=True)
            n += 1
    return n


def renumber_speakers(root: Path) -> int:
    """Rename speaker dirs to sequential integers (ref 01_:3-9)."""
    dirs = sorted(d for d in root.iterdir() if d.is_dir())
    for i, d in enumerate(dirs, start=1):
        if d.name != str(i):
            d.rename(root / str(i))
    return len(dirs)


def extract_valset(train_root: Path, val_root: Path, n_speakers: int = 5, n_files: int = 3, seed: int = 0) -> int:
    """Move a few random files from the largest speakers to val (ref 02_:5-24)."""
    rng = random.Random(seed)
    speakers = sorted(
        (d for d in train_root.iterdir() if d.is_dir()),
        key=lambda d: -len(list(d.glob("*.wav"))),
    )[:n_speakers]
    moved = 0
    for spk in speakers:
        wavs = sorted(spk.glob("*.wav"))
        for wav in rng.sample(wavs, min(n_files, len(wavs))):
            dst = val_root / spk.name
            dst.mkdir(parents=True, exist_ok=True)
            shutil.move(str(wav), dst / wav.name)
            txt = wav.with_suffix(".txt")
            if txt.exists():
                shutil.move(str(txt), dst / txt.name)
            moved += 1
    return moved


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root", type=Path, help="audio root (e.g. data/train/audio)")
    p.add_argument("--max-sec", type=float, help="delete wavs at least this long")
    p.add_argument("--renumber", action="store_true", help="rename speaker dirs to 1..N")
    p.add_argument("--valset", type=Path, help="move random files to this val audio root")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.max_sec:
        print(f"deleted {drop_long_audio(args.root, args.max_sec)} long files")
    if args.renumber:
        print(f"renumbered {renumber_speakers(args.root)} speaker dirs")
    if args.valset:
        print(f"moved {extract_valset(args.root, args.valset, seed=args.seed)} files to val")


if __name__ == "__main__":
    main()
