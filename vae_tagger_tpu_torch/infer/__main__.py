"""Image tagging CLI: ``python -m vae_tagger_tpu_torch.infer``.

Takes the flags of the JAX package's ``scripts/infer_full.py`` that this
slice supports, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path).
"""

from __future__ import annotations

import argparse

from ..core.cli import resolve_attention_flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.infer",
        description="Classify images with the VAE + tagger decoder.")
    p.add_argument("--vae_checkpoint", type=str, required=True,
                   help="pretrained VAE weights (.safetensors/.bin)")
    p.add_argument("--vae_config_path", type=str, default=None,
                   help="VAE config file (diffusers-style JSON)")
    p.add_argument("--decoder_checkpoint", type=str, required=True,
                   help="decoder weights (.bin/.pth)")
    p.add_argument("--image_path", type=str, required=True,
                   help="an image file or a directory of images")
    p.add_argument("--tags_csv_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="inference_output")
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--confidence_threshold", type=float, default=0.5)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=4,
                   help="decode threads overlapping the device")
    p.add_argument("--prefetch_factor", type=int, default=2,
                   help="batches staged ahead of the device")
    p.add_argument("--mixed_precision", type=str, default=None,
                   help="no|fp16|bf16 (fp16 and bf16 both run bf16)")
    p.add_argument("--use_attention", action="store_true", default=True,
                   help="use the attention decoder (default on)")
    p.add_argument("--no_attention", action="store_true",
                   help="disable the attention decoder")
    p.add_argument("--use_spatial_attention", action="store_true",
                   default=True)
    p.add_argument("--use_self_attention", action="store_true", default=True)
    p.add_argument("--use_cross_attention", action="store_true")
    p.add_argument("--attention_heads", type=int, default=8)
    p.add_argument("--attention_dropout", type=float, default=0.1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    from .classify import infer_and_classify
    from .engine import TaggerEngine

    args = build_parser().parse_args(argv)
    attention_config = resolve_attention_flags(args)
    engine = TaggerEngine.load(
        vae_checkpoint=args.vae_checkpoint,
        decoder_checkpoint=args.decoder_checkpoint,
        tags_csv_path=args.tags_csv_path,
        vae_config_path=args.vae_config_path,
        use_attention=args.use_attention,
        attention_config=attention_config,
        mixed_precision=args.mixed_precision,
        device=args.device,
    )
    return infer_and_classify(
        engine, args.image_path, output_dir=args.output_dir,
        resolution=args.resolution,
        confidence_threshold=args.confidence_threshold,
        batch_size=args.batch_size, num_workers=args.num_workers,
        prefetch_factor=args.prefetch_factor)


if __name__ == "__main__":
    main()
