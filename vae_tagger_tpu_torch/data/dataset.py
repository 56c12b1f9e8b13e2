"""Tag list loading (the port's copy of ``load_tag_names`` from
``vae_tagger_tpu/data/dataset.py``)."""

from __future__ import annotations

import csv
from typing import List


def load_tag_names(tags_csv_path: str) -> List[str]:
    """Read the ``name`` column of a tags CSV; row order defines the class
    index (any ``count`` column is informational)."""
    with open(tags_csv_path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or "name" not in reader.fieldnames:
            raise ValueError(f"{tags_csv_path} must contain a 'name' column")
        return [str(row["name"]) for row in reader]
