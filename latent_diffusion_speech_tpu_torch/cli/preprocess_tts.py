"""Stage 16: text -> `utt/*.npy` = (phones, tones, lang_ids, word2ph).

Counterpart of `latent_diffusion_speech_tpu/cli/preprocess_tts.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.preprocess_tts -c configs/config.yaml [--language EN]

Reads each speaker's `utt_text.txt` (stage 15), runs the port's text frontend
(`text.text_to_sequence`, 'phone' mode: G2P to phone / tone ids) on every
audio file's label, and saves the object-dtype npy tuple the JAX stage
writes, at `<path>/utt/<speaker>/<file>.<ext>.npy`, for the train path.
'text' mode writes the WordPiece ids of each label instead
(`text/bert.py::get_bert_token`, a local `vocab.txt`: $LDS_BERT_VOCAB or one
under `pretrain/`) with empty tone, language and word2ph arrays.  The LM
config mappers pin `mode="phone"` in both packages, so a text-mode corpus
trains as phone ids (ROADMAP.md Queue 3, R12).  Host-only: no torch.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load
from latent_diffusion_speech_tpu_torch.data.files import traverse_dir

__all__ = ["process_tts", "main"]


def process_tts(path_root: str | Path, mode: str = "phone", language: str = "ZH", extensions=("wav",)):
    """Yields (file name, number of phones) as each `utt/` file is saved."""
    from latent_diffusion_speech_tpu_torch.text import text_to_sequence

    root = Path(path_root)
    utt_text, prev_spk = {}, None
    for name_ext in traverse_dir(root / "audio", extensions=extensions):
        spk = str(Path(name_ext).parent)
        if spk != prev_spk:
            utt_file = root / "audio" / spk / "utt_text.txt"
            utt_text = {}
            if utt_file.exists():
                for line in utt_file.read_text(encoding="utf-8").splitlines():
                    if "|" in line:
                        k, v = line.split("|", 1)
                        utt_text[k] = v
            prev_spk = spk
        stem = Path(name_ext).stem
        if stem not in utt_text:
            continue
        if mode == "phone":
            (phones, tones, lang_ids), (_norm, word2ph) = text_to_sequence(utt_text[stem], language)
        else:
            # 'text' mode: BERT tokenizer ids, empty tone / language / word2ph
            from latent_diffusion_speech_tpu_torch.text.bert import get_bert_token

            phones, _tokens = get_bert_token(utt_text[stem])
            tones = lang_ids = word2ph = []
        out = root / "utt" / (name_ext + ".npy")
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(
            out,
            np.array((np.array(phones), np.array(tones), np.array(lang_ids), np.array(word2ph)), dtype=object),
            allow_pickle=True,
        )
        yield name_ext, len(phones)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = config_parser("text -> utt npy (stage 16)")
    p.add_argument("--language", type=str, default="ZH")
    args = p.parse_args(argv)
    cfg = load(args)
    for name, n in process_tts(cfg.data.train_path, cfg.text2semantic.model.mode, args.language,
                               tuple(cfg.data.extensions)):
        print(f"utt: {name} -> {n} phones")


if __name__ == "__main__":
    main()
