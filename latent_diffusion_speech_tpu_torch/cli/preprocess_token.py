"""Stage 19: units -> semantic token ids (`semantic_token/*.npy`) on one CUDA device.

Counterpart of `latent_diffusion_speech_tpu/cli/preprocess_token.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.preprocess_token -c configs/config.yaml

Each file of `<path>/units` is snapped to its nearest k-means centroids of
`text2semantic.model.codebook_path` (`kmeans_predict`: one K6 launch a
file on the card) and saved as int32 ids, for the train and valid paths.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load
from latent_diffusion_speech_tpu_torch.data.files import traverse_dir
from latent_diffusion_speech_tpu_torch.ops.layers import resolve_device
from latent_diffusion_speech_tpu_torch.quantize.kmeans import kmeans_predict, load_codebook

__all__ = ["tokenize_units", "main"]


def tokenize_units(path_root, codebook: np.ndarray, device=None):
    """Yields (file name, ids shape) as each file's ids are saved.  device:
    None means `cuda` (raises without a card)."""
    root = Path(path_root)
    centroids = torch.as_tensor(codebook, dtype=torch.float32, device=resolve_device(device))
    for name in traverse_dir(root / "units", extensions=("npy",)):
        units = np.load(root / "units" / name).astype(np.float32)
        ids = kmeans_predict(units, centroids).cpu().numpy().astype(np.int32)
        out = root / "semantic_token" / name
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, ids)
        yield name, ids.shape


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = config_parser("units -> semantic tokens (stage 19)")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    cfg = load(args)
    device = resolve_device(args.device)
    codebook = load_codebook(cfg.text2semantic.model.codebook_path)
    for path in (cfg.data.train_path, cfg.data.valid_path):
        for name, shape in tokenize_units(path, codebook, device=device):
            print(f"token: {name} -> {shape}")


if __name__ == "__main__":
    main()
