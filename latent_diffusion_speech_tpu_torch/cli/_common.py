"""Shared CLI plumbing (counterpart of `latent_diffusion_speech_tpu/cli/_common.py`)."""

from __future__ import annotations

import argparse
from pathlib import Path

from latent_diffusion_speech_tpu_torch.config import Config, load_config


def config_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-c", "--config", type=str, default="configs/config.yaml")
    return p


def load(args) -> Config:
    path = Path(args.config)
    if not path.exists():
        raise SystemExit(f"[x] config not found: {path}")
    return load_config(path)
