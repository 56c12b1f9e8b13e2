from .bucketing import (
    AspectRatioBucketing,
    ImageSizeManifest,
    SmartResize,
    decode_bytes_square,
    load_and_transform_image,
    load_and_transform_image_yuv,
    to_yuv420,
)
from .dataset import TaggedImageDataset, load_tag_names, parse_weighted_tags
from .loader import BucketBatchSampler, DataLoader, train_val_split
from .paths import SUPPORTED_EXTENSIONS, get_image_paths

__all__ = [
    "AspectRatioBucketing",
    "ImageSizeManifest",
    "SmartResize",
    "BucketBatchSampler",
    "DataLoader",
    "SUPPORTED_EXTENSIONS",
    "TaggedImageDataset",
    "decode_bytes_square",
    "get_image_paths",
    "load_and_transform_image",
    "load_and_transform_image_yuv",
    "load_tag_names",
    "parse_weighted_tags",
    "to_yuv420",
    "train_val_split",
]
