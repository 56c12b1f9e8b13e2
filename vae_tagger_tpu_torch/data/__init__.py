from .bucketing import decode_bytes_square, load_and_transform_image
from .dataset import load_tag_names
from .paths import SUPPORTED_EXTENSIONS, get_image_paths

__all__ = [
    "SUPPORTED_EXTENSIONS",
    "decode_bytes_square",
    "get_image_paths",
    "load_and_transform_image",
    "load_tag_names",
]
