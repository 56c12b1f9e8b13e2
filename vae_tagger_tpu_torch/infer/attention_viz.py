"""Attention maps of the tagger head, written to disk (the port's
counterpart of ``vae_tagger_tpu/infer/attention_viz.py`` and
``scripts/attention_maps.py``):

    python -m vae_tagger_tpu_torch.infer.attention_viz \\
        --vae_checkpoint vae/diffusion_pytorch_model.safetensors \\
        --vae_config_path vae/config.json \\
        --decoder_checkpoint pytorch_model.bin --tags_csv_path tags.csv \\
        --image_path images/ [--device cpu]

The engine (``TaggerEngine.get_attention_maps``) returns the head's maps
for a pixel batch (models/taggers.py::get_attention_maps), and this module
writes, per image:

- ``<stem>_attention.npz``: the raw maps (fp16: sigmoid gates and softmax
  weights, visualization-precision data);
- ``<stem>_spatial.png`` / ``<stem>_mhsa.png``: heat overlays on the
  model-input image: the CBAM spatial gate, and the MHSA "attention
  received" per latent position (softmax column mass, head mean);

and ``attention_maps_index.json``: what was written, with shapes.  Pure
numpy + PIL.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
from PIL import Image

from ..data.bucketing import load_and_transform_image
from ..data.paths import get_image_paths

# 5-anchor heat LUT (dark violet -> red -> yellow), interpolated to 256
_ANCHORS = np.array([[13, 8, 65], [106, 23, 110], [201, 62, 74],
                     [245, 125, 21], [250, 235, 100]], np.float32)


def _heat_rgb(v: np.ndarray) -> np.ndarray:
    """(H, W) in [0,1] -> (H, W, 3) uint8 heat colors."""
    x = np.clip(v, 0.0, 1.0) * (len(_ANCHORS) - 1)
    i = np.minimum(x.astype(np.int32), len(_ANCHORS) - 2)
    t = (x - i)[..., None]
    return ((1 - t) * _ANCHORS[i] + t * _ANCHORS[i + 1]).astype(np.uint8)


def _overlay(image_u8: np.ndarray, heat01: np.ndarray,
             alpha: float = 0.55) -> Image.Image:
    """Blend a [0,1] heat map (any grid size) over an HWC uint8 image."""
    h, w = image_u8.shape[:2]
    heat = np.asarray(Image.fromarray(
        (np.clip(heat01, 0, 1) * 255).astype(np.uint8)).resize(
            (w, h), Image.BILINEAR), np.float32) / 255.0
    colored = _heat_rgb(heat).astype(np.float32)
    a = (alpha * heat)[..., None]  # weight by intensity: cool stays photo
    out = (1 - a) * image_u8.astype(np.float32) + a * colored
    return Image.fromarray(out.astype(np.uint8))


def _normalize01(m: np.ndarray) -> np.ndarray:
    lo, hi = float(m.min()), float(m.max())
    return (m - lo) / (hi - lo) if hi > lo else np.zeros_like(m)


def dump_attention_maps(engine, image_path: str, output_dir: str,
                        resolution: int = 512, batch_size: int = 8,
                        save_overlays: bool = True,
                        max_images: Optional[int] = None) -> dict:
    """Run every image under ``image_path`` through the tagger head and
    write its attention maps (the module docstring lists the files).

    Returns the index dict that is also written to
    ``output_dir/attention_maps_index.json``."""
    paths = get_image_paths(image_path)
    if max_images:
        paths = paths[:max_images]
    if not paths:
        raise FileNotFoundError(f"no images under {image_path}")
    os.makedirs(output_dir, exist_ok=True)

    # discovery is recursive, so basenames can repeat across subdirectories;
    # disambiguate repeats with a counter suffix instead of overwriting
    seen: dict = {}
    stems = []
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        n = seen.get(stem, 0)
        seen[stem] = n + 1
        stems.append(stem if n == 0 else f"{stem}__{n}")

    index = {"resolution": resolution, "images": {}}
    for start in range(0, len(paths), batch_size):
        chunk = paths[start:start + batch_size]
        pixels = np.stack([load_and_transform_image(p, resolution=resolution)
                           for p in chunk])
        maps = engine.get_attention_maps(pixels)
        for j, p in enumerate(chunk):
            stem = stems[start + j]
            per_image = {k: np.asarray(v[j], np.float16)
                         for k, v in maps.items()}
            npz_path = os.path.join(output_dir, f"{stem}_attention.npz")
            np.savez_compressed(npz_path, **per_image)
            entry = {"npz": os.path.basename(npz_path),
                     "maps": {k: list(v.shape)
                              for k, v in per_image.items()}}

            if save_overlays and "spatial_attention" in per_image:
                gate = _normalize01(
                    per_image["spatial_attention"][..., 0].astype(np.float32))
                out = os.path.join(output_dir, f"{stem}_spatial.png")
                _overlay(pixels[j], gate).save(out)
                entry["spatial_overlay"] = os.path.basename(out)
            if save_overlays and "self_attention" in per_image:
                # (heads, S, S) -> attention RECEIVED by each position:
                # column mass, head-mean, back onto the sqrt(S) latent grid
                w = per_image["self_attention"].astype(np.float32)
                received = w.mean(axis=0).sum(axis=0)  # (S,)
                side = int(round(len(received) ** 0.5))
                if side * side == len(received):
                    grid = _normalize01(received.reshape(side, side))
                    out = os.path.join(output_dir, f"{stem}_mhsa.png")
                    _overlay(pixels[j], grid).save(out)
                    entry["mhsa_overlay"] = os.path.basename(out)
            index["images"][str(p)] = entry
        print(f"attention maps: {min(start + batch_size, len(paths))}"
              f"/{len(paths)}")

    index_path = os.path.join(output_dir, "attention_maps_index.json")
    with open(index_path, "w", encoding="utf-8") as f:
        json.dump(index, f, indent=2)
    print(f"wrote {len(index['images'])} images' maps to {output_dir}")
    return index


def build_parser() -> argparse.ArgumentParser:
    from ..core.cli import (
        add_attention_args,
        add_decoder_ckpt_arg,
        add_vae_args,
    )

    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.infer.attention_viz",
        description="Extract attention maps (NPZ + PNG overlays) from the "
        "tagger head.")
    add_vae_args(p, require_checkpoint=True)
    add_decoder_ckpt_arg(p, required=True)
    p.add_argument("--image_path", type=str, required=True,
                   help="an image file or a directory of images")
    p.add_argument("--tags_csv_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="attention_output")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--no_overlays", action="store_true",
                   help="write only the raw NPZ maps")
    p.add_argument("--mixed_precision", type=str, default=None,
                   help="no|fp16|bf16 (fp16 and bf16 both run bf16)")
    add_attention_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    from ..core.cli import resolve_attention_flags
    from .engine import TaggerEngine

    parser = build_parser()
    args = parser.parse_args(argv)
    attention_config = resolve_attention_flags(args)
    if not args.use_attention:
        parser.error("the plain ClassificationDecoder has no attention "
                     "maps; this tool needs an attention head checkpoint")
    engine = TaggerEngine.load(
        vae_checkpoint=args.vae_checkpoint,
        decoder_checkpoint=args.decoder_checkpoint,
        tags_csv_path=args.tags_csv_path,
        vae_config_path=args.vae_config_path,
        use_attention=True, attention_config=attention_config,
        mixed_precision=args.mixed_precision, device=args.device)
    return dump_attention_maps(engine, args.image_path, args.output_dir,
                               resolution=args.resolution,
                               batch_size=args.batch_size,
                               save_overlays=not args.no_overlays,
                               max_images=args.max_images)


if __name__ == "__main__":
    main()
