"""Tag list loading, weighted multi-labels and the triplet-mining dataset
(the port's copy of ``vae_tagger_tpu/data/dataset.py``).

Dataset format (the reference's):
  data.json:  {"path/to/img.png": "tag_a:1.0, tag_b:0.8, tag_c", ...}
  tags.csv:   a ``name`` column; row order defines the class index.

Labels live in one dense (N, num_tags) float32 matrix; ``__getitem__``
returns HWC uint8 numpy (normalization happens on the device).  Triplets
are mined per (seed, epoch, anchor) with the JAX package's generator and
hash seed, so both packages mine the same triplets.

- ``use_bucketing``: each image's aspect-ratio bucket is assigned at
  construction from its header (or the size manifest beside data.json);
  the positive and negative of a triplet are loaded into the anchor's
  bucket, so one batch is one shape.
- ``transfer_format="yuv420"``: each image travels as ``<key>_y`` (H, W)
  and ``<key>_cbcr`` (2, H/2, W/2) planar uint8, half of RGB's bytes; the
  transform is unchanged and its result converted (the train steps turn
  the planes back into RGB on the device, train/steps.py).
- Each item carries ``load_ok``: False marks the black placeholder of an
  unreadable image, which the latent cache of train_decoder never keeps.
"""

from __future__ import annotations

import csv
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from .bucketing import (
    AspectRatioBucketing,
    ImageSizeManifest,
    dummy_image,
    load_and_transform_image,
    to_yuv420,
)


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
                 resolution: Optional[int] = 512, max_candidates: int = 100,
                 seed: Optional[int] = None, return_triplets: bool = True,
                 use_bucketing: bool = False, base_resolution: int = 512,
                 max_resolution: int = 1024, bucket_step: int = 64,
                 crop_mode: str = "center", transfer_format: str = "rgb"):
        with open(json_path, "r", encoding="utf-8") as f:
            self.data = json.load(f)
        self.tags = load_tag_names(tags_csv_path)
        self.tag_to_idx = {t: i for i, t in enumerate(self.tags)}
        self.image_paths: List[str] = list(self.data.keys())
        self.resolution = resolution
        self.max_candidates = max_candidates
        self.return_triplets = return_triplets
        # a deterministic transform ('center') is what the latent cache of
        # train_decoder keys on; any other crop mode turns the cache off
        self.crop_mode = crop_mode
        if transfer_format not in ("rgb", "yuv420"):
            raise ValueError(f"unknown transfer_format {transfer_format!r}")
        if transfer_format == "yuv420":
            dims = ([base_resolution, bucket_step] if use_bucketing
                    else [resolution or 512])
            if any(d % 2 for d in dims):
                raise ValueError("yuv420 transfer needs even image dims; "
                                 f"got {dims}")
        self.transfer_format = transfer_format
        self._seed = seed if seed is not None else 0
        self.epoch = 0
        self.labels_matrix = np.stack([
            parse_weighted_tags(self.data[p], self.tag_to_idx, len(self.tags))
            for p in self.image_paths
        ]) if self.image_paths else np.zeros((0, len(self.tags)), np.float32)
        self.use_bucketing = use_bucketing
        self.bucketing = None
        if use_bucketing:
            print("aspect-ratio bucketing enabled...")
            self.bucketing = AspectRatioBucketing(
                base_resolution, max_resolution, bucket_step)
            manifest = ImageSizeManifest.for_dataset(json_path)
            for p in self.image_paths:
                self.bucketing.assign_bucket(p, manifest=manifest)
            manifest.save()
            self.bucketing.print_bucket_info()

    def class_distribution(self) -> np.ndarray:
        """Positive-image count per tag."""
        from ..losses.combined import compute_class_distribution

        return compute_class_distribution(self.labels_matrix)

    def set_epoch(self, epoch: int) -> None:
        """Vary the mined triplets across epochs, deterministically."""
        self.epoch = epoch

    def bucket_of(self, idx: int) -> Optional[Tuple[int, int]]:
        """The (width, height) bucket of sample ``idx``; None without
        bucketing."""
        if not self.use_bucketing:
            return None
        return self.bucketing.image_buckets.get(self.image_paths[idx])

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

    def _load(self, idx: int, bucket_idx: Optional[int] = None
              ) -> np.ndarray:
        return self._load_checked(idx, bucket_idx)[0]

    def _load_checked(self, idx: int, bucket_idx: Optional[int] = None):
        """(image, ok), resized into the bucket of sample ``bucket_idx``
        (default ``idx``); ok is False for the placeholder of an
        unreadable image."""
        path = self.image_paths[idx]
        bucket = self.bucket_of(idx if bucket_idx is None else bucket_idx)
        try:
            return load_and_transform_image(
                path, resolution=self.resolution, bucket=bucket,
                crop_mode=self.crop_mode), True
        except Exception as e:
            print(f"warning: could not load image {path}: {e}")
            if bucket is not None:
                return dummy_image(bucket[0], bucket[1]), False
            side = self.resolution or 512
            return dummy_image(side, side), False

    def _emit(self, item: dict, key: str, image: np.ndarray) -> None:
        """Store ``image`` under ``key`` in the dataset's wire format."""
        if self.transfer_format == "yuv420":
            item[key + "_y"], item[key + "_cbcr"] = to_yuv420(image)
        else:
            item[key] = image

    def __getitem__(self, idx: int) -> dict:
        anchor, load_ok = self._load_checked(idx)
        item = {"labels": self.labels_matrix[idx], "index": idx,
                "load_ok": np.bool_(load_ok)}
        if not self.return_triplets:
            self._emit(item, "pixel_values", anchor)
            return item
        pos_idx, neg_idx = self._mine_triplet(idx)
        self._emit(item, "anchor", anchor)
        self._emit(item, "positive", anchor if pos_idx == idx
                   else self._load(pos_idx, bucket_idx=idx))
        self._emit(item, "negative", anchor if neg_idx == idx
                   else self._load(neg_idx, bucket_idx=idx))
        item.update(positive_labels=self.labels_matrix[pos_idx],
                    negative_labels=self.labels_matrix[neg_idx])
        return item
