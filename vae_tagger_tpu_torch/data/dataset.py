"""Tag list loading, weighted multi-labels and the triplet-mining dataset
(the port's copy of ``vae_tagger_tpu/data/dataset.py``, square path).

Dataset format (the reference's):
  data.json:  {"path/to/img.png": "tag_a:1.0, tag_b:0.8, tag_c", ...}
  tags.csv:   a ``name`` column; row order defines the class index.

Labels live in one dense (N, num_tags) float32 matrix; ``__getitem__``
returns HWC uint8 numpy (normalization happens on the device).  Triplets
are mined per (seed, epoch, anchor) with the JAX package's generator and
hash seed, so both packages mine the same triplets.  Aspect-ratio
bucketing and the YUV wire format wait for a later slice.
"""

from __future__ import annotations

import csv
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from .bucketing import dummy_image, load_and_transform_image


def load_tag_names(tags_csv_path: str) -> List[str]:
    """Read the ``name`` column of a tags CSV; row order defines the class
    index (any ``count`` column is informational)."""
    with open(tags_csv_path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or "name" not in reader.fieldnames:
            raise ValueError(f"{tags_csv_path} must contain a 'name' column")
        return [str(row["name"]) for row in reader]


def parse_weighted_tags(prompt: str, tag_to_idx: Dict[str, int],
                        num_tags: int) -> np.ndarray:
    """'tag_a:1.0, tag_b:0.8, tag_c' -> float32 label vector.  A missing or
    malformed weight is 1.0; unknown tags are ignored."""
    labels = np.zeros(num_tags, dtype=np.float32)
    for entry in str(prompt).split(","):
        entry = entry.strip()
        if not entry:
            continue
        if ":" in entry:
            tag, weight_s = entry.split(":", 1)
            tag = tag.strip()
            try:
                weight = float(weight_s.strip())
            except ValueError:
                weight = 1.0
        else:
            tag, weight = entry, 1.0
        if tag in tag_to_idx:
            labels[tag_to_idx[tag]] = weight
    return labels


class TaggedImageDataset:
    """Map-style dataset; ``__getitem__`` returns a dict of numpy arrays:
    with ``return_triplets`` (the trainers) the mined triplet anchor/
    positive/negative (HWC uint8) and labels/positive_labels/
    negative_labels (float32 vectors), else the classification form,
    ``pixel_values`` and ``labels`` (evaluation)."""

    def __init__(self, json_path: str, tags_csv_path: str,
                 resolution: int = 512, max_candidates: int = 100,
                 seed: Optional[int] = None, return_triplets: bool = True):
        with open(json_path, "r", encoding="utf-8") as f:
            self.data = json.load(f)
        self.tags = load_tag_names(tags_csv_path)
        self.tag_to_idx = {t: i for i, t in enumerate(self.tags)}
        self.image_paths: List[str] = list(self.data.keys())
        self.resolution = resolution
        self.max_candidates = max_candidates
        self.return_triplets = return_triplets
        self._seed = seed if seed is not None else 0
        self.epoch = 0
        self.labels_matrix = np.stack([
            parse_weighted_tags(self.data[p], self.tag_to_idx, len(self.tags))
            for p in self.image_paths
        ]) if self.image_paths else np.zeros((0, len(self.tags)), np.float32)

    def class_distribution(self) -> np.ndarray:
        """Positive-image count per tag."""
        from ..losses.combined import compute_class_distribution

        return compute_class_distribution(self.labels_matrix)

    def set_epoch(self, epoch: int) -> None:
        """Vary the mined triplets across epochs, deterministically."""
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.image_paths)

    def _mine_triplet(self, anchor_idx: int) -> Tuple[int, int]:
        # per-(seed, epoch, anchor) generator: the same under any loader
        # thread schedule; hash of an int tuple does not depend on
        # PYTHONHASHSEED
        rng = np.random.default_rng(
            hash((self._seed, self.epoch, anchor_idx)) & 0xFFFFFFFFFFFFFFFF)
        n = len(self.image_paths)
        anchor_tag_count = float(self.labels_matrix[anchor_idx].sum())
        k = min(self.max_candidates, max(0, n - 1))
        if k <= 0:
            return anchor_idx, anchor_idx
        # k candidates without replacement over [0, n) without the anchor
        cand = rng.choice(n - 1, size=k, replace=False).astype(np.int64)
        cand += cand >= anchor_idx
        overlaps = (self.labels_matrix[cand]
                    * self.labels_matrix[anchor_idx]).sum(axis=1)
        positives = cand[overlaps > 0]
        negatives = cand[overlaps <= 0]

        if anchor_tag_count > 1 and positives.size:
            pos_overlaps = overlaps[overlaps > 0]
            # the max-overlap positive with p=0.7 when there is a choice
            if positives.size > 1 and rng.random() < 0.7:
                positive_idx = int(positives[int(np.argmax(pos_overlaps))])
            else:
                positive_idx = int(rng.choice(positives))
        elif positives.size:
            positive_idx = int(rng.choice(positives))
        else:
            positive_idx = anchor_idx

        if negatives.size:
            negative_idx = int(rng.choice(negatives))
        else:
            negative_idx = int(rng.integers(n - 1))
            negative_idx += negative_idx >= anchor_idx
        return positive_idx, negative_idx

    def _load(self, idx: int) -> np.ndarray:
        path = self.image_paths[idx]
        try:
            return load_and_transform_image(path, self.resolution)
        except (OSError, ValueError) as e:
            print(f"warning: could not load image {path}: {e}")
            return dummy_image(self.resolution, self.resolution)

    def __getitem__(self, idx: int) -> dict:
        anchor = self._load(idx)
        if not self.return_triplets:
            return {"labels": self.labels_matrix[idx], "index": idx,
                    "pixel_values": anchor}
        pos_idx, neg_idx = self._mine_triplet(idx)
        return {
            "labels": self.labels_matrix[idx], "index": idx,
            "anchor": anchor,
            "positive": anchor if pos_idx == idx else self._load(pos_idx),
            "negative": anchor if neg_idx == idx else self._load(neg_idx),
            "positive_labels": self.labels_matrix[pos_idx],
            "negative_labels": self.labels_matrix[neg_idx],
        }
