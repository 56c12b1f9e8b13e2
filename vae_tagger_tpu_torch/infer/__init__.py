from .classify import infer_and_classify
from .engine import TaggerEngine, VAEOnlyEngine, build_decoder
from .latents import flatten_latent_torch_order, infer_and_save_latents
from .pipeline import iter_image_batches, pad_tail_rows

__all__ = [
    "TaggerEngine",
    "VAEOnlyEngine",
    "build_decoder",
    "flatten_latent_torch_order",
    "infer_and_classify",
    "infer_and_save_latents",
    "iter_image_batches",
    "pad_tail_rows",
]
