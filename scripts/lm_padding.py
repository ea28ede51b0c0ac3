"""Padding share of LM training batches, with and without length sorting.

Counts the semantic positions that stage 21's batches pad (collate with
pad-to-32 buckets, B=32, `pool_factor` 50: `cli/train_lm.py`'s loader) over
a few epochs of a seeded corpus, for several corpus sizes.  Semantic
lengths are drawn uniformly over 150-1022 tokens, the span of
`chip_smoke.py`'s smoke corpus, with one phone per 7 tokens.  Needs numpy
only (no card, no torch):

    python3 scripts/lm_padding.py [--sizes 96 1000 4000 16000] [--epochs 3]
"""

from __future__ import annotations

import argparse
import os
import sys
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from latent_diffusion_speech_tpu_torch.data.lm_dataset import collate_text_batch  # noqa: E402
from latent_diffusion_speech_tpu_torch.data.loader import DataLoader  # noqa: E402


class LengthCorpus:
    """Items of the given semantic lengths (zeros: only their sizes count)."""

    def __init__(self, lengths: np.ndarray):
        self.lengths = lengths

    def __len__(self) -> int:
        return len(self.lengths)

    def item_lengths(self) -> np.ndarray:
        return self.lengths

    def __getitem__(self, i: int) -> dict:
        n, p = int(self.lengths[i]), max(1, int(self.lengths[i]) // 7)
        return {"phone": np.zeros(p, np.int32), "tone": np.zeros(p, np.int32),
                "semantic": np.zeros(n, np.int32), "spk_id": np.zeros(p, np.int32)}


def padding_share(loader: DataLoader, epochs: int) -> float:
    real = total = 0
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        for b in loader:
            real += int(b["attention_mask"].sum())
            total += b["attention_mask"].size
    return 1.0 - real / total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[96, 1000, 4000, 16000])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    collate = partial(collate_text_batch, phone_pad=0, semantic_pad=0)
    for n in args.sizes:
        corpus = LengthCorpus(np.random.default_rng(args.seed).integers(150, 1023, n))
        shares = {sort: padding_share(DataLoader(corpus, args.batch_size, collate=collate, seed=args.seed,
                                                 length_sorted=sort), args.epochs)
                  for sort in (True, False)}
        print(f"{n} utterances, B={args.batch_size}, {args.epochs} epochs: padding {shares[True]:.1%} with "
              f"length_sorted, {shares[False]:.1%} without")
    return 0


if __name__ == "__main__":
    sys.exit(main())
