from .classify import infer_and_classify
from .engine import TaggerEngine, build_decoder
from .pipeline import iter_image_batches, pad_tail_rows

__all__ = [
    "TaggerEngine",
    "build_decoder",
    "infer_and_classify",
    "iter_image_batches",
    "pad_tail_rows",
]
