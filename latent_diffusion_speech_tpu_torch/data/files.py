"""Filesystem helpers for the pipeline data layout.

A copy of `latent_diffusion_speech_tpu/data/files.py`, with the listing
options the port does not use left out.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Sequence

__all__ = ["traverse_dir", "speaker_id_map"]


def traverse_dir(root: str | Path, extensions: Sequence[str] = ("wav",)) -> List[str]:
    """Recursive file listing: sorted paths relative to `root`, with one of
    `extensions`."""
    root = Path(root)
    if not root.exists():
        return []
    out = []
    for dirpath, _, filenames in os.walk(root):
        for fn in filenames:
            if any(fn.endswith("." + e) for e in extensions):
                out.append(str((Path(dirpath) / fn).relative_to(root)))
    return sorted(out)


def speaker_id_map(paths: Sequence[str]) -> Dict[str, int]:
    """Directory -> 1-based speaker id, in path order (ids are assigned as
    new speaker directories appear in the sorted traversal)."""
    mapping: Dict[str, int] = {}
    next_id = 1
    for p in paths:
        d = os.path.dirname(p)
        if d not in mapping:
            mapping[d] = next_id
            next_id += 1
    return mapping
