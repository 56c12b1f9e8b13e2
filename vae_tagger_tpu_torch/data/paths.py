"""Image path discovery (the port's copy of
``vae_tagger_tpu/data/paths.py``)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import List

SUPPORTED_EXTENSIONS = [".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".webp"]


def get_image_paths(path: str) -> List[Path]:
    """Recursive, case-insensitive, deduplicated image discovery; a single
    file path passes through."""
    image_paths: List[Path] = []
    if os.path.isdir(path):
        found = set()
        for ext in SUPPORTED_EXTENSIONS:
            for p in Path(path).rglob(f"*{ext}"):
                found.add(p.resolve())
            for p in Path(path).rglob(f"*{ext.upper()}"):
                found.add(p.resolve())
        image_paths = sorted(found)
    elif os.path.isfile(path):
        if any(path.lower().endswith(ext) for ext in SUPPORTED_EXTENSIONS):
            image_paths.append(Path(path))
        else:
            print(f"warning: {path} is not a supported image format")
    else:
        print(f"error: path {path} does not exist")
    return image_paths
