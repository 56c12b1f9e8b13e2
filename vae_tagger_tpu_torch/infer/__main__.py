"""Image tagging CLI: ``python -m vae_tagger_tpu_torch.infer``.

Takes the flags of the JAX package's ``scripts/infer_full.py``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
``--transfer_format yuv420`` ships planar 4:2:0 to the card.  On a host
with several GPUs it runs one engine replica on each and splits every
batch over them, the batch raised to at least 8 a GPU
(parallel/mesh.py::auto_data_parallel); ``--no_data_parallel`` keeps one
GPU.  ``--spatial_parallel`` instead shards each image's height over every
local GPU (``TaggerEngine.with_spatial``; latency mode: the batch is not
scaled, and ``--transfer_format yuv420`` is ignored for RGB); a no-op on
one device.  ``--model_checkpoint`` (deprecated) stands in for a missing
``--vae_checkpoint`` or ``--decoder_checkpoint``.
"""

from __future__ import annotations

import argparse

from ..core.cli import refuse_unported, resolve_attention_flags
from ..parallel import mesh
from ..parallel.spatial import spatial_parallel_enabled


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.infer",
        description="Classify images with the VAE + tagger decoder.")
    p.add_argument("--vae_checkpoint", type=str, default=None,
                   help="pretrained VAE weights (.safetensors/.bin)")
    p.add_argument("--vae_config_path", type=str, default=None,
                   help="VAE config file (diffusers-style JSON)")
    p.add_argument("--decoder_checkpoint", type=str, default=None,
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
    p.add_argument("--transfer_format", type=str, default="rgb",
                   choices=["rgb", "yuv420"],
                   help="host->device wire format: yuv420 ships planar "
                   "4:2:0 at half of RGB's bytes; tags match RGB within "
                   "the chroma subsampling's noise")
    p.add_argument("--no_data_parallel", action="store_true",
                   help="one GPU instead of a replica on every local GPU")
    p.add_argument("--spatial_parallel", action="store_true",
                   help="shard each image's height over every local GPU "
                   "(latency mode) instead of replicating; a no-op on one "
                   "device")
    p.add_argument("--model_checkpoint", type=str, default=None,
                   help="(deprecated) parent path for both checkpoints")
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

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.model_checkpoint and (not args.vae_checkpoint
                                  or not args.decoder_checkpoint):
        print("back-compat mode: deriving checkpoint paths from "
              "--model_checkpoint")
        args.vae_checkpoint = args.vae_checkpoint or args.model_checkpoint
        args.decoder_checkpoint = (args.decoder_checkpoint
                                   or args.model_checkpoint)
    if not args.vae_checkpoint or not args.decoder_checkpoint:
        parser.error("--vae_checkpoint and --decoder_checkpoint are "
                     "required (or --model_checkpoint)")
    refuse_unported(args, mesh.process_count())
    local = mesh.local_devices(args.device)
    spatial = spatial_parallel_enabled(args, local)
    if spatial:
        devices, batch_size = None, args.batch_size
    else:
        devices, batch_size = mesh.auto_data_parallel(
            args.batch_size, not args.no_data_parallel, device=args.device)
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
    if devices:
        engine = engine.with_devices(devices)
    if spatial:
        engine = engine.with_spatial(local)
        print(f"spatial-parallel inference over {len(local)} devices "
              f"(image height sharded; latency mode)")
        if args.transfer_format != "rgb":
            print("spatial parallelism uses RGB transfer "
                  "(--transfer_format yuv420 ignored)")
            args.transfer_format = "rgb"
    return infer_and_classify(
        engine, args.image_path, output_dir=args.output_dir,
        resolution=args.resolution,
        confidence_threshold=args.confidence_threshold,
        batch_size=batch_size, num_workers=args.num_workers,
        prefetch_factor=args.prefetch_factor,
        transfer_format=args.transfer_format)


if __name__ == "__main__":
    main()
