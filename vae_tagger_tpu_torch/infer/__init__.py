from .classify import infer_and_classify
from .engine import TaggerEngine, VAEOnlyEngine, build_decoder
from .latents import (
    flatten_latent_torch_order,
    infer_and_save_latents,
    infer_and_save_latents_tiled,
)
from .pipeline import iter_image_batches, pad_tail_rows
from .tiled import TiledVAE

__all__ = [
    "TaggerEngine",
    "TiledVAE",
    "VAEOnlyEngine",
    "build_decoder",
    "flatten_latent_torch_order",
    "infer_and_classify",
    "infer_and_save_latents",
    "infer_and_save_latents_tiled",
    "iter_image_batches",
    "pad_tail_rows",
]
