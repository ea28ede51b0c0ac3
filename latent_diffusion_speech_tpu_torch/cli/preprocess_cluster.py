"""Stage 17: fit the k-means semantic codebook over unit files.

Counterpart of `latent_diffusion_speech_tpu/cli/preprocess_cluster.py` (the
reference's `17_preprocess_train_cluster.py`: at most 30000 unit files,
4096 clusters):

    python -m latent_diffusion_speech_tpu_torch.cli.preprocess_cluster -c configs/config.yaml \\
        [--out pretrain/semantic_codebook.npz] [--epochs 4] [--device cpu]

Reads `<data.train_path>/units/*.npy` (stage 10), fits the minibatch EMA
k-means of `quantize/kmeans.py::kmeans_fit` (each step's assignment one K6
launch on the card) and saves the centroids to
`text2semantic.model.codebook_path`, which stage 19, LM training and
serving read.  f32 with TF32 off, on the card unless `--device` says
otherwise.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load
from latent_diffusion_speech_tpu_torch.data.files import traverse_dir
from latent_diffusion_speech_tpu_torch.ops.layers import no_tf32, resolve_device
from latent_diffusion_speech_tpu_torch.quantize.kmeans import kmeans_fit, save_codebook

__all__ = ["fit_codebook", "main"]


def fit_codebook(path_root, k=4096, max_files=30000, epochs=4, batch_size=8192, seed=0, verbose=True, device=None):
    """(centroids (k, D) f32, the last epoch's inertia per point) over the
    first `max_files` unit files of `<path_root>/units`.  device: None
    means `cuda` (raises without a card)."""
    root = Path(path_root)
    files = traverse_dir(root / "units", extensions=("npy",))[:max_files]
    if not files:
        raise SystemExit(f"[x] no unit files under {root / 'units'}")
    data = np.concatenate([np.load(root / "units" / f) for f in files]).astype(np.float32)
    if verbose:
        print(f"kmeans: {data.shape[0]} frames x {data.shape[1]} dims from {len(files)} files")
    return kmeans_fit(data, k=k, epochs=epochs, batch_size=batch_size, seed=seed, verbose=verbose, device=device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = config_parser("fit k-means semantic codebook (stage 17)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    cfg = load(args)
    device = resolve_device(args.device)
    no_tf32()
    centroids, inertia = fit_codebook(
        cfg.data.train_path, k=cfg.text2semantic.model.semantic_kmeans_num, epochs=args.epochs, device=device
    )
    out = args.out or cfg.text2semantic.model.codebook_path
    save_codebook(out, centroids)
    print(f"saved {centroids.shape} codebook to {out} (inertia/point {inertia:.4f})")


if __name__ == "__main__":
    main()
