"""Stage 15: merge per-utterance `.txt` labels into one file per speaker.

Counterpart of `latent_diffusion_speech_tpu/cli/preprocess_text.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.preprocess_text -c configs/config.yaml

For each speaker directory of `<path>/audio`, its `<name>.txt` labels become
the lines `<name>|<text>` of `utt_text.txt` there, for the train and valid
paths.  Host-only: no torch.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load

__all__ = ["merge_labels", "main"]


def merge_labels(path_root: str | Path) -> int:
    """Write each speaker's `utt_text.txt`; returns the number of labels."""
    root = Path(path_root) / "audio"
    n = 0
    for spk_dir in sorted(d for d in root.iterdir() if d.is_dir()):
        lines = []
        for txt in sorted(spk_dir.glob("*.txt")):
            if txt.name == "utt_text.txt":
                continue
            text = txt.read_text(encoding="utf-8").strip().replace("\n", " ")
            lines.append(f"{txt.stem}|{text}")
            n += 1
        if lines:
            (spk_dir / "utt_text.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return n


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = config_parser("merge text labels (stage 15)").parse_args(argv)
    cfg = load(args)
    for path in (cfg.data.train_path, cfg.data.valid_path):
        print(f"{path}: merged {merge_labels(path)} labels")


if __name__ == "__main__":
    main()
