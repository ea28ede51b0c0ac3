"""Locate text-frontend data files (pinyin map, CMU dict).

Search order: package `data/` dir -> $LDS_TEXT_DATA_DIR.  These are public
data artifacts (opencpop pinyin mapping, CMUdict); the frontend reads them in
place rather than vendoring multi-MB copies.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

_PACKAGE_DATA = Path(__file__).parent / "data"


def find_data_file(name: str) -> Optional[Path]:
    candidates = [
        _PACKAGE_DATA / name,
        Path(os.environ["LDS_TEXT_DATA_DIR"]) / name if os.environ.get("LDS_TEXT_DATA_DIR") else None,
    ]
    for c in candidates:
        if c is not None and c.exists():
            return c
    return None
