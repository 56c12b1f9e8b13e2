"""VAE round trip: ``python -m vae_tagger_tpu_torch.infer.reconstruct`` (the
port's counterpart of ``scripts/vae_reconstruction_test.py``, same flags,
plus ``--device``).

Encode -> sample -> decode a given image or a procedural test image, then
print the MSE against the normalized input, PSNR = 20 log10(2) -
10 log10(MSE) (pixels span [-1, 1]) and the compression ratio, and write
``original.png``, ``reconstructed.png`` and the latent as
``latent_vector.npy`` (NHWC) and ``latent_vector.pt`` (NCHW).  The direct
path resizes to ``--resolution`` and samples the posterior with a
``torch.Generator`` seeded from ``--seed``; ``--tiled`` keeps the image's
native size and round-trips the posterior mode through overlapping tiles
(infer/tiled.py).  The 3-panel comparison figure needs matplotlib and is
skipped with a printed line when it is missing.  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def create_test_image(size=(512, 512)):
    """Procedural fixture: RGB gradients, a white disc and a red square."""
    from PIL import Image

    width, height = size
    img = np.zeros((height, width, 3), dtype=np.uint8)
    img[:, :, 0] = np.linspace(0, 255, width, dtype=np.uint8)[None, :]
    img[:, :, 1] = np.linspace(255, 0, height, dtype=np.uint8)[:, None]
    img[:, :, 2] = 128
    cy, cx = height // 2, width // 2
    yy, xx = np.ogrid[:height, :width]
    img[(xx - cx) ** 2 + (yy - cy) ** 2 <= (min(size) // 6) ** 2] = [
        255, 255, 255]
    r = min(size) // 8
    img[cy - r:cy + r, cx - r:cx + r] = [255, 0, 0]
    return Image.fromarray(img)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.infer.reconstruct",
        description="VAE reconstruction test")
    p.add_argument("--vae_checkpoint", type=str, default=None)
    p.add_argument("--vae_config_path", type=str, default=None)
    p.add_argument("--image_path", type=str, default=None,
                   help="optional; a procedural test image when omitted")
    p.add_argument("--output_dir", type=str,
                   default="vae_reconstruction_output")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--show_result", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiled", action="store_true",
                   help="round-trip at the image's native resolution through "
                   "fixed-shape overlapping tiles (posterior mode instead "
                   "of a sample; device memory bounded by one tile batch)")
    p.add_argument("--tile_size", type=int, default=1024)
    p.add_argument("--tile_overlap", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def roundtrip(vae, pixels_u8: np.ndarray, *, tiled: bool = False,
              tile: int = 1024, overlap: int = 256, seed: int = 0,
              compute_dtype=torch.float32):
    """(x, latent, recon): the input normalized to [-1, 1], the raw
    (unscaled) latent, and the reconstruction, each (1, H, W, C) fp32
    numpy.  Direct: a posterior sample from a generator seeded with
    ``seed``; tiled: the posterior mode, through :class:`TiledVAE`."""
    from ..models.autoencoder_kl import decode_scaled
    from ..ops.image import normalize_uint8

    x = np.asarray(pixels_u8, np.float32)[None] / 127.5 - 1.0
    if tiled:
        from .tiled import TiledVAE

        tiler = TiledVAE(vae, tile=tile, overlap=overlap,
                         compute_dtype=compute_dtype)
        z_scaled = tiler.encode(pixels_u8)
        latent = decode_scaled(torch.from_numpy(z_scaled),
                               vae.config).numpy()[None]
        recon = tiler.decode(z_scaled)[None][:, :x.shape[1], :x.shape[2]]
        return x, latent, recon
    device = next(vae.parameters()).device
    with torch.inference_mode():
        px = torch.from_numpy(np.array(pixels_u8, np.uint8))[None].to(
            device)
        posterior = vae.encode(normalize_uint8(px, compute_dtype))
        z = posterior.sample(torch.Generator(device=device).manual_seed(seed))
        recon = vae.decode(z, compute_dtype)
    return x, z.float().cpu().numpy(), recon.cpu().numpy()


def psnr_of(mse: float) -> float:
    """PSNR in dB of pixels spanning [-1, 1] (peak-to-peak 2)."""
    return float(20 * np.log10(2.0) - 10 * np.log10(mse))


def main(argv=None) -> dict:
    from PIL import Image

    from ..core.device import resolve_device
    from ..io.checkpoints import load_vae

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if not args.vae_checkpoint and not args.vae_config_path:
        print("warning: no VAE checkpoint/config given; using a fresh model "
              "with the default config")
    vae = load_vae(args.vae_checkpoint, args.vae_config_path,
                   require_checkpoint=False, resolution=args.resolution,
                   with_decoder=True).to(device).eval()

    if args.image_path and os.path.exists(args.image_path):
        original = Image.open(args.image_path).convert("RGB")
        print(f"loaded image: {args.image_path}")
    else:
        original = create_test_image((args.resolution, args.resolution))
        print("using a generated test image")
    if not args.tiled:
        original = original.resize((args.resolution, args.resolution),
                                   Image.LANCZOS)
    pixels = np.asarray(original, np.uint8)
    if args.tiled:
        print(f"running TILED VAE encode/decode at native "
              f"{pixels.shape[1]}x{pixels.shape[0]} (tile {args.tile_size}, "
              f"overlap {args.tile_overlap})...")
    else:
        print("running VAE encode/decode...")
    x, latent, recon = roundtrip(
        vae, pixels, tiled=args.tiled, tile=args.tile_size,
        overlap=args.tile_overlap, seed=args.seed)
    print(f"latent shape: {latent.shape}")
    print(f"latent stats: mean={latent.mean():.4f}, std={latent.std():.4f}")

    mse = float(np.mean((x - recon) ** 2))
    psnr = psnr_of(mse)
    compression = x.size / latent.size
    recon_img = Image.fromarray(
        (np.clip(recon[0] * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8))

    os.makedirs(args.output_dir, exist_ok=True)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        axes[0].imshow(original)
        axes[0].set_title("Original Image", fontsize=14)
        axes[1].imshow(recon_img)
        axes[1].set_title(f"VAE reconstruction\nMSE Loss: {mse:.6f}",
                          fontsize=14)
        diff = np.abs(np.asarray(original, float)
                      - np.asarray(recon_img, float))
        axes[2].imshow(diff / diff.max() if diff.max() > 0 else diff)
        axes[2].set_title("difference (abs)", fontsize=14)
        for ax in axes:
            ax.axis("off")
        plt.tight_layout()
        cmp_path = os.path.join(args.output_dir,
                                "vae_reconstruction_comparison.png")
        plt.savefig(cmp_path, dpi=300, bbox_inches="tight")
        print(f"comparison saved to: {cmp_path}")
        if args.show_result:
            plt.show()
    except Exception as e:
        print(f"matplotlib comparison skipped: {e}")

    original.save(os.path.join(args.output_dir, "original.png"))
    recon_img.save(os.path.join(args.output_dir, "reconstructed.png"))
    np.save(os.path.join(args.output_dir, "latent_vector.npy"), latent)
    torch.save(torch.from_numpy(latent.transpose(0, 3, 1, 2).copy()),
               os.path.join(args.output_dir, "latent_vector.pt"))

    print("VAE reconstruction test complete!")
    print(f"input resolution: {x.shape[2]}x{x.shape[1]}"
          + (" (native, tiled)" if args.tiled else ""))
    print(f"latent shape: {latent.shape}")
    print(f"compression ratio: {compression:.2f}:1")
    print(f"reconstruction MSE: {mse:.6f}")
    print(f"PSNR: {psnr:.2f} dB")
    return dict(mse=mse, psnr=psnr, compression=compression,
                latent_shape=tuple(latent.shape))


if __name__ == "__main__":
    main()
