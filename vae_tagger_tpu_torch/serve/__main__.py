"""Serve the tagger over HTTP: ``python -m vae_tagger_tpu_torch.serve``.

Takes the flags of the JAX package's ``scripts/serve.py``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
Loads the infer CLI's artifacts (VAE safetensors + config JSON, the head's
``pytorch_model.bin``, tags CSV) and serves ``POST /classify``,
``GET /healthz`` and ``GET /tags`` (serve/server.py).  On a host with
several GPUs it serves from one engine replica on each, every coalesced
batch split over them, and ``--max_batch`` defaults to 8 a GPU (8 on
one); ``--no_data_parallel`` keeps one GPU.  ``--spatial_parallel``
instead shards each image's height over every local GPU
(``TaggerEngine.with_spatial``; latency mode: ``--max_batch`` defaults to
8, and ``--transfer_format yuv420`` is ignored for RGB); a no-op on one
device.
"""

from __future__ import annotations

import argparse

from ..core.cli import refuse_unported
from ..parallel import mesh
from ..parallel.spatial import spatial_parallel_enabled


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m vae_tagger_tpu_torch.serve",
                                description="vae-tagger HTTP server")
    p.add_argument("--vae_checkpoint", type=str, required=True)
    p.add_argument("--decoder_checkpoint", type=str, required=True)
    p.add_argument("--tags_csv_path", type=str, required=True)
    p.add_argument("--vae_config_path", type=str, default=None)
    p.add_argument("--resolution", type=int, nargs="+", default=[1024],
                   help="served resolution(s); the first is the default, "
                   "the others are chosen with POST /classify?resolution=N")
    p.add_argument("--confidence_threshold", type=float, default=0.5)
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="bind address (no auth: 0.0.0.0 is an explicit "
                   "opt-in)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=None,
                   help="most images a batch coalesces (default 8, times "
                   "the GPUs under data parallelism)")
    p.add_argument("--batch_timeout_ms", type=float, default=10.0)
    p.add_argument("--request_timeout_s", type=float, default=600.0)
    p.add_argument("--max_body_mb", type=float, default=32.0,
                   help="a larger request gets 413 before its body is read")
    p.add_argument("--max_queue", type=int, default=64,
                   help="pending-request cap; beyond it requests get 503")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--no_data_parallel", action="store_true",
                   help="one GPU instead of a replica on every local GPU")
    p.add_argument("--spatial_parallel", action="store_true",
                   help="shard each image's height over every local GPU "
                   "(latency mode) instead of replicating; a no-op on one "
                   "device")
    p.add_argument("--no_attention", action="store_true")
    p.add_argument("--transfer_format", type=str, default="rgb",
                   choices=["rgb", "yuv420"],
                   help="host->device wire format: yuv420 ships planar "
                   "4:2:0 at half of RGB's bytes")
    p.add_argument("--mixed_precision", type=str, default=None,
                   help="no|fp16|bf16 (fp16 and bf16 both run bf16)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def build_server(args):
    """The engine and the (not yet serving) server of parsed ``args``."""
    from ..infer.engine import TaggerEngine
    from .server import TaggerServer

    refuse_unported(args, mesh.process_count())
    local = mesh.local_devices(args.device)
    spatial = spatial_parallel_enabled(args, local)
    if spatial:
        devices, default_max_batch = None, 8
    else:
        devices, default_max_batch = mesh.auto_data_parallel(
            8, not args.no_data_parallel, what="serving",
            batch_label="default max_batch", device=args.device)
    engine = TaggerEngine.load(
        vae_checkpoint=args.vae_checkpoint,
        decoder_checkpoint=args.decoder_checkpoint,
        tags_csv_path=args.tags_csv_path,
        vae_config_path=args.vae_config_path,
        use_attention=not args.no_attention,
        mixed_precision=args.mixed_precision,
        device=args.device)
    if devices:
        engine = engine.with_devices(devices)
    if spatial:
        engine = engine.with_spatial(local)
        print(f"spatial-parallel serving over {len(local)} devices (image "
              f"height sharded; latency mode)")
        if args.transfer_format != "rgb":
            print("spatial parallelism uses RGB transfer "
                  "(--transfer_format yuv420 ignored)")
            args.transfer_format = "rgb"
    return TaggerServer(engine, resolution=tuple(args.resolution),
                        threshold=args.confidence_threshold,
                        host=args.host, port=args.port,
                        max_batch=args.max_batch or default_max_batch,
                        batch_timeout_ms=args.batch_timeout_ms,
                        request_timeout_s=args.request_timeout_s,
                        warmup=not args.no_warmup,
                        max_body_bytes=int(args.max_body_mb * 1024 * 1024),
                        max_queue=args.max_queue,
                        transfer_format=args.transfer_format)


def main(argv=None):
    build_server(build_parser().parse_args(argv)).serve_forever()


if __name__ == "__main__":
    main()
