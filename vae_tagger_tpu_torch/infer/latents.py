"""Latent extraction: images -> flattened latent vectors (the port's copy
of ``vae_tagger_tpu/infer/latents.py``).

``latent_vectors.json`` in the reference's format, {image_path: [flat
latent floats]}, each latent flattened in NCHW (channel-major) order so
that vectors interchange with the reference's; or ``latent_vectors.npz``,
one fp32 array per image path.  Images are decoded on a thread pool a batch
ahead of the card, and one batch stays in flight on the card while the
previous one is flattened.  ``--transfer_format yuv420`` ships planar
4:2:0 to the card (half of RGB's bytes).  ``--tiled`` encodes each image
at its native size through fixed-shape overlapping tiles (infer/tiled.py)
instead of the square resize; the latent grids then vary per image.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..data.paths import get_image_paths
from ..utils.pipelining import OneInFlight
from ..utils.profiling import ThroughputMeter
from .engine import VAEOnlyEngine
from .pipeline import iter_image_batches, pad_tail_rows


def flatten_latent_torch_order(latent_nhwc: np.ndarray) -> np.ndarray:
    """(h, w, C) -> flat (C*h*w,) channel-major (torch NCHW flatten order)."""
    return np.transpose(latent_nhwc, (2, 0, 1)).reshape(-1)


def infer_and_save_latents(engine: VAEOnlyEngine, image_path: str,
                           output_dir: str = "inference_output",
                           resolution: int = 1024, batch_size: int = 8,
                           verbose: bool = True, num_workers: int = 4,
                           prefetch_factor: int = 2,
                           output_format: str = "json",
                           transfer_format: str = "rgb") -> dict:
    """Encode a file or directory of images with ``engine`` (a
    :class:`VAEOnlyEngine` or a ``TaggerEngine``) and write their latents;
    returns {path: flat latent} (lists for json, arrays for npz)."""
    if output_format not in ("json", "npz"):
        raise ValueError(f"unknown output_format {output_format!r}")
    image_paths = get_image_paths(image_path)
    if not image_paths:
        print("no image files found; check the path")
        return {}

    latent_data = {}
    processed, errors = 0, 0
    meter = ThroughputMeter()

    def resolve(batch_paths, latents_dev, n):
        nonlocal processed
        latents = latents_dev.float().cpu().numpy()[:n]
        for path, z in zip(batch_paths, latents):
            flat = flatten_latent_torch_order(z)
            latent_data[path] = (flat.tolist() if output_format == "json"
                                 else flat)
        processed += n
        meter.update(n)

    pipeline = OneInFlight(resolve)
    encode_async = (engine.encode_yuv_async if transfer_format == "yuv420"
                    else engine.encode_async)
    for evt in iter_image_batches(image_paths, resolution, batch_size,
                                  num_workers, prefetch_factor,
                                  pixel_format=transfer_format):
        if evt[0] == "error":
            errors += 1
            print(f"skipping image {evt[1]}: {evt[2]}")
            continue
        _, batch_paths, block = evt
        block = pad_tail_rows(block, batch_size)
        latents_dev, _ = (encode_async(*block) if isinstance(block, tuple)
                          else encode_async(block))
        pipeline.submit(batch_paths, latents_dev, len(batch_paths))
    pipeline.flush()

    if verbose:
        print(f"done -- ok: {processed}, failed: {errors}, "
              f"total: {len(image_paths)}, {meter.report()}")
    return _save(latent_data, output_dir, output_format, verbose)


def _save(latent_data: dict, output_dir: str, output_format: str,
          verbose: bool) -> dict:
    """Write ``latent_vectors.json`` or ``latent_vectors.npz``."""
    output_path = Path(output_dir) / ("latent_vectors.npz"
                                      if output_format == "npz"
                                      else "latent_vectors.json")
    output_path.parent.mkdir(parents=True, exist_ok=True)
    if output_format == "npz":
        np.savez_compressed(output_path, **latent_data)
    else:
        with open(output_path, "w", encoding="utf-8") as f:
            json.dump(latent_data, f, indent=4)
    if verbose:
        print(f"latent vectors saved to: {output_path}")
    return latent_data


def infer_and_save_latents_tiled(vae, image_path: str,
                                 output_dir: str = "inference_output",
                                 tile: int = 1024, overlap: int = 256,
                                 output_format: str = "json",
                                 verbose: bool = True,
                                 compute_dtype=None) -> dict:
    """Native-resolution latent extraction through the tiled encode: each
    image keeps its own size (a (ceil(H/8), ceil(W/8)) latent grid) and the
    device holds one tile batch at a time.  The output schema is that of
    :func:`infer_and_save_latents` (flat channel-major latents, whose
    lengths now vary per image)."""
    import torch
    from PIL import Image

    from .tiled import TiledVAE

    if output_format not in ("json", "npz"):
        raise ValueError(f"unknown output_format {output_format!r}")
    image_paths = get_image_paths(image_path)
    if not image_paths:
        print("no image files found; check the path")
        return {}

    tiler = TiledVAE(vae, tile=tile, overlap=overlap,
                     compute_dtype=compute_dtype or torch.float32)
    latent_data, errors = {}, 0
    meter = ThroughputMeter()
    for path in image_paths:
        try:
            img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
            z = tiler.encode(img)
        except Exception as e:
            errors += 1
            print(f"skipping image {path}: {e}")
            continue
        flat = flatten_latent_torch_order(np.asarray(z, np.float32))
        latent_data[str(path)] = (flat.tolist() if output_format == "json"
                                  else flat)
        meter.update(1)
        if verbose:
            print(f"{path}: {img.shape[1]}x{img.shape[0]} -> latent "
                  f"{z.shape[1]}x{z.shape[0]}x{z.shape[2]}")
    if verbose:
        print(f"done -- ok: {len(latent_data)}, failed: {errors}, "
              f"{meter.report()}")
    return _save(latent_data, output_dir, output_format, verbose)


def main(argv=None) -> dict:
    """``python -m vae_tagger_tpu_torch.infer.latents``: the flags of the
    JAX package's ``scripts/infer_vae.py``, plus ``--device`` (default
    ``cuda``; ``cpu`` runs the plain PyTorch path)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.infer.latents",
        description="Run VAE inference and save latent vectors.")
    p.add_argument("--vae_checkpoint", type=str, required=True,
                   help="pretrained VAE weights (.safetensors/.bin)")
    p.add_argument("--vae_config_path", type=str, default=None,
                   help="VAE config file (diffusers-style JSON)")
    p.add_argument("--image_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="inference_output")
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=4,
                   help="decode threads overlapping the device")
    p.add_argument("--prefetch_factor", type=int, default=2,
                   help="batches staged ahead of the device")
    p.add_argument("--mixed_precision", type=str, default=None,
                   help="no|fp16|bf16 (fp16 and bf16 both run bf16)")
    p.add_argument("--output_format", type=str, default="json",
                   choices=["json", "npz"])
    p.add_argument("--transfer_format", type=str, default="rgb",
                   choices=["rgb", "yuv420"],
                   help="host->device wire format: yuv420 ships planar "
                   "4:2:0 at half of RGB's bytes")
    p.add_argument("--tiled", action="store_true",
                   help="encode each image at its native resolution through "
                   "fixed-shape overlapping tiles (posterior mode; device "
                   "memory bounded by one tile batch)")
    p.add_argument("--tile_size", type=int, default=1024)
    p.add_argument("--tile_overlap", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    engine = VAEOnlyEngine.load(args.vae_checkpoint, args.vae_config_path,
                                args.mixed_precision, args.device)
    if args.tiled:
        if args.transfer_format != "rgb":
            print("--tiled reads images at native resolution on the host "
                  "(--transfer_format yuv420 ignored)")
        return infer_and_save_latents_tiled(
            engine.vae, args.image_path, output_dir=args.output_dir,
            tile=args.tile_size, overlap=args.tile_overlap,
            output_format=args.output_format,
            compute_dtype=engine.policy.compute_dtype)
    return infer_and_save_latents(
        engine, args.image_path, output_dir=args.output_dir,
        resolution=args.resolution, batch_size=args.batch_size,
        num_workers=args.num_workers, prefetch_factor=args.prefetch_factor,
        output_format=args.output_format,
        transfer_format=args.transfer_format)


if __name__ == "__main__":
    main()
