"""Batched preprocessing: units and latents in one pass, in device batches.

Counterpart of `latent_diffusion_speech_tpu/cli/batch_preprocess.py`:

    python -m latent_diffusion_speech_tpu_torch.cli.batch_preprocess -c configs/config.yaml \\
        [--ckpt pretrain/large-v3_encoder.pt] [--batch-size 8] [--device cpu]

Every file of `<data.train_path>/audio` is read at the encoder rate and
held in host memory (as JAX holds it); files are grouped by half-second
length bucket into batches, zero-padded to the bucket, and each batch goes
through the units encoder and the codec encoder in one call each.  Outputs
are cropped to each file's true frame count (`len // encoder_hop_size`
units, `int(len * sample_rate / encoder_sr) // vocoder_hop_size` latent
frames) and written by a thread pool as f32 `units/<name>.npy` and
`mel/<name>.npy`.  As in JAX, the codec is given the encoder-rate audio
resampled to its own rate, so these latents lack the band above half the
encoder rate that stage 11's (read at the corpus rate) have.  Files are
sharded as `files[process_index::process_count]`; `main` takes the rank and
world size of an initialised `torch.distributed` group, else (0, 1).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load
from latent_diffusion_speech_tpu_torch.data.files import traverse_dir
from latent_diffusion_speech_tpu_torch.ops.audio_io import load_audio

__all__ = ["batch_extract", "main"]


def _buckets(lengths: Dict[str, int], batch_size: int, step: int) -> List[List[str]]:
    """Group file names into batches of similar (bucketed) length."""
    by_bucket: Dict[int, List[str]] = {}
    for name, n in lengths.items():
        b = max(step, ((n + step - 1) // step) * step)
        by_bucket.setdefault(b, []).append(name)
    batches = []
    for b in sorted(by_bucket):
        names = by_bucket[b]
        for i in range(0, len(names), batch_size):
            batches.append(names[i : i + batch_size])
    return batches


def _write(path: Path, arr: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, arr)


def batch_extract(
    path_root,
    units_encoder=None,
    vocoder=None,
    sample_rate: int = 44100,
    encoder_sr: int = 16000,
    batch_size: int = 8,
    extensions=("wav",),
    process_index: int = 0,
    process_count: int = 1,
    writers: int = 4,
):
    """Yields (files done, files of this process) after each batch; every
    file is written when the generator is exhausted (a failed write raises
    there)."""
    root = Path(path_root)
    files = traverse_dir(root / "audio", extensions=extensions)[process_index::process_count]

    audio_cache: Dict[str, np.ndarray] = {}
    lengths: Dict[str, int] = {}
    for name in files:
        audio, _ = load_audio(root / "audio" / name, target_sr=encoder_sr)
        audio_cache[name] = audio
        lengths[name] = len(audio)

    step = encoder_sr // 2
    n_done = 0
    with ThreadPoolExecutor(max_workers=writers) as pool:
        pending = []
        for batch_names in _buckets(lengths, batch_size, step):
            max_len = max(lengths[n] for n in batch_names)
            pad_len = max(step, ((max_len + step - 1) // step) * step)
            batch = np.zeros((len(batch_names), pad_len), np.float32)
            for i, n in enumerate(batch_names):
                batch[i, : lengths[n]] = audio_cache[n]

            if units_encoder is not None:
                units = units_encoder.encode(batch, encoder_sr).float().cpu().numpy()
                for i, n in enumerate(batch_names):
                    true = lengths[n] // units_encoder.encoder_hop_size
                    pending.append(pool.submit(_write, root / "units" / (n + ".npy"), units[i, :true]))

            if vocoder is not None:
                ratio = sample_rate / encoder_sr
                lat = vocoder.extract(batch, encoder_sr).float().cpu().numpy()
                for i, n in enumerate(batch_names):
                    true = int(lengths[n] * ratio) // vocoder.vocoder_hop_size
                    pending.append(pool.submit(_write, root / "mel" / (n + ".npy"), lat[i, :true]))

            n_done += len(batch_names)
            yield n_done, len(files)
    for future in pending:
        future.result()


def _process_index_count() -> tuple:
    from latent_diffusion_speech_tpu_torch.parallel.dist import process_count, process_index

    return process_index(), process_count()


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = config_parser("batched unit+latent extraction")
    p.add_argument("--ckpt", type=str, default="pretrain/large-v3_encoder.pt")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    cfg = load(args)

    from latent_diffusion_speech_tpu_torch.models.units import UnitsEncoder
    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
    from latent_diffusion_speech_tpu_torch.ops.layers import no_tf32, resolve_device

    device = resolve_device(args.device)
    no_tf32()  # the codec in f32, as stage 11
    encoder = UnitsEncoder(
        cfg.data.encoder, cfg.data.encoder_sample_rate, cfg.data.encoder_hop_size,
        cfg.data.units_forced_mode, ckpt_path=args.ckpt, device=device,
    )
    vocoder = Vocoder(cfg.common.vocoder.type, device=device, ckpt=cfg.common.vocoder.ckpt)
    rank, world = _process_index_count()
    for done, total in batch_extract(
        cfg.data.train_path, encoder, vocoder, cfg.data.sampling_rate,
        cfg.data.encoder_sample_rate, args.batch_size, tuple(cfg.data.extensions), rank, world,
    ):
        print(f"batch_preprocess: {done}/{total}")


if __name__ == "__main__":
    main()
