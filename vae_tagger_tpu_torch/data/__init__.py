from .bucketing import decode_bytes_square, load_and_transform_image
from .dataset import TaggedImageDataset, load_tag_names, parse_weighted_tags
from .loader import BucketBatchSampler, DataLoader, train_val_split
from .paths import SUPPORTED_EXTENSIONS, get_image_paths

__all__ = [
    "BucketBatchSampler",
    "DataLoader",
    "SUPPORTED_EXTENSIONS",
    "TaggedImageDataset",
    "decode_bytes_square",
    "get_image_paths",
    "load_and_transform_image",
    "load_tag_names",
    "parse_weighted_tags",
    "train_val_split",
]
