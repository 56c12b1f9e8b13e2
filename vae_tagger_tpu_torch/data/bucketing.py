"""Image decode, aspect-ratio bucketing and the YUV 4:2:0 host transform
(the port's copy of ``vae_tagger_tpu/data/bucketing.py``).

- Decode and resize go through the native library (``native/``: a fused
  decode + crop + resize of JPEG, PNG and WebP, the JPEG one DCT-scaled)
  wherever it builds, and through PIL for what it declines, with the JAX
  package's dispatch and switches, so both give the same pixels:
  ``VAE_TAGGER_NATIVE_RESIZE=0`` is PIL only, ``VAE_TAGGER_NATIVE_DECODE=0``
  decodes with PIL and resizes natively, ``VAE_TAGGER_DECODE_EXACT=1``
  turns the JPEG DCT scaling off.
- The square transform resizes every image to (resolution, resolution)
  with a BILINEAR filter, distorting the aspect ratio (the reference's
  plain transform).
- Buckets are every (W, H) with W, H in [base, max] at ``bucket_step``
  and W * H <= max^2, sorted; an image goes to the first bucket in that
  order whose aspect ratio is nearest its own.  ``SmartResize`` crops to
  the bucket's ratio, then LANCZOS-resizes.
- ``ImageSizeManifest`` keeps each image's pixel size beside
  ``data.json``, so a warm start opens no image header.
- ``to_yuv420`` turns a transformed RGB image into planar 4:2:0 for the
  YUV wire format (the device turns it back, ops/image.py).
"""

from __future__ import annotations

import io
import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from .. import native


def _jpeg_quality_factor() -> int:
    """The JPEG decode policy of the native path: 2, a DCT-domain scaled
    decode that keeps at least twice the target; 0, a full decode, with
    ``VAE_TAGGER_DECODE_EXACT=1``."""
    return 0 if os.environ.get("VAE_TAGGER_DECODE_EXACT") == "1" else 2


def _random_offset(ow: int, oh: int, width: int, height: int):
    """SmartResize's random crop offset, drawn as it draws it."""
    target_ratio = width / height
    original_ratio = ow / oh
    if original_ratio > target_ratio:
        return random.randint(0, ow - int(oh * target_ratio)), 0
    if original_ratio < target_ratio:
        return 0, random.randint(0, oh - int(ow / target_ratio))
    return 0, 0


class SmartResize:
    """Aspect-preserving crop to the target ratio, then LANCZOS resize.

    crop_mode: 'center' (default), 'random', or anything else for a zero
    offset (the reference's else-branch)."""

    def __init__(self, target_width: int, target_height: int,
                 crop_mode: str = "center"):
        self.target_width = target_width
        self.target_height = target_height
        self.crop_mode = crop_mode

    def __call__(self, img: Image.Image) -> Image.Image:
        ow, oh = img.size
        target_ratio = self.target_width / self.target_height
        original_ratio = ow / oh
        if original_ratio > target_ratio:
            nw, nh = int(oh * target_ratio), oh
            if self.crop_mode == "center":
                left = (ow - nw) // 2
            elif self.crop_mode == "random":
                left = random.randint(0, ow - nw)
            else:
                left = 0
            img = img.crop((left, 0, left + nw, nh))
        elif original_ratio < target_ratio:
            nw, nh = ow, int(ow / target_ratio)
            if self.crop_mode == "center":
                top = (oh - nh) // 2
            elif self.crop_mode == "random":
                top = random.randint(0, oh - nh)
            else:
                top = 0
            img = img.crop((0, top, nw, top + nh))
        return img.resize((self.target_width, self.target_height),
                          Image.LANCZOS)


class AspectRatioBucketing:
    """The bucket grid, and each image's bucket by nearest aspect ratio."""

    def __init__(self, base_resolution: int = 512, max_resolution: int = 1024,
                 bucket_step: int = 64):
        self.base_resolution = base_resolution
        self.max_resolution = max_resolution
        self.bucket_step = bucket_step
        self.buckets = self._generate_buckets()
        self.image_buckets: Dict[str, Tuple[int, int]] = {}

    def _generate_buckets(self) -> List[Tuple[int, int]]:
        sides = range(self.base_resolution, self.max_resolution + 1,
                      self.bucket_step)
        return sorted((w, h) for w in sides for h in sides
                      if w * h <= self.max_resolution ** 2)

    def assign_bucket_for_size(self, width: int,
                               height: int) -> Tuple[int, int]:
        """The first bucket, in sorted order, with the least aspect-ratio
        difference (a 4:3 image goes to (768, 576), not (1024, 768))."""
        original_ratio = width / height
        best_bucket, min_diff = None, float("inf")
        for bw, bh in self.buckets:
            diff = abs(bw / bh - original_ratio)
            if diff < min_diff:
                min_diff, best_bucket = diff, (bw, bh)
        return best_bucket

    def assign_bucket(self, image_path,
                      manifest: Optional["ImageSizeManifest"] = None
                      ) -> Tuple[int, int]:
        """Assign by pixel size: from the manifest when the file is
        unchanged, else from its header.  An unreadable image goes to the
        square base bucket."""
        size = manifest.lookup(image_path) if manifest is not None else None
        if size is None:
            size = read_image_size(image_path)
            if size is not None and manifest is not None:
                manifest.record(image_path, size)
        bucket = (self.assign_bucket_for_size(*size) if size is not None
                  else (self.base_resolution, self.base_resolution))
        self.image_buckets[str(image_path)] = bucket
        return bucket

    def get_bucket_statistics(self) -> Dict[Tuple[int, int], int]:
        counts: Dict[Tuple[int, int], int] = {}
        for bucket in self.image_buckets.values():
            counts[bucket] = counts.get(bucket, 0) + 1
        return counts

    def print_bucket_info(self) -> None:
        stats = self.get_bucket_statistics()
        print("aspect-ratio bucket statistics")
        print(f"generated {len(self.buckets)} buckets")
        print(f"used {len(stats)} buckets")
        total = max(1, len(self.image_buckets))
        for (w, h), count in sorted(stats.items(), key=lambda x: x[1],
                                    reverse=True):
            print(f"{w}x{h} (ratio {w / h:.2f}): {count} images "
                  f"({100.0 * count / total:.1f}%)")


def read_image_size(path) -> Optional[Tuple[int, int]]:
    """(width, height) from the image header alone; None for an unreadable
    file."""
    try:
        with Image.open(path) as img:
            return img.size
    except Exception as e:
        print(f"warning: could not analyze image {path}: {e}")
        return None


class ImageSizeManifest:
    """Persisted path -> (mtime_ns, file size, width, height).

    A path whose (mtime_ns, size) is unchanged costs one ``os.stat`` on a
    warm start; new or changed files get their header read again.  Pixel
    sizes, not buckets, are kept, so one manifest serves every bucket grid.
    It lives beside data.json (``<data.json>.bucket_manifest.json``) and is
    written atomically (a temporary file, then a rename), so concurrent
    trainers race harmlessly; an unwritable directory leaves it a cache of
    this run only.  ``VAE_TAGGER_NO_BUCKET_MANIFEST=1`` turns it off."""

    VERSION = 1

    def __init__(self, manifest_file: Optional[str]):
        self.path = manifest_file
        self._entries: Dict[str, list] = {}
        self._dirty = False
        if manifest_file and os.path.exists(manifest_file):
            try:
                with open(manifest_file, "r", encoding="utf-8") as f:
                    payload = json.load(f)
                if payload.get("version") == self.VERSION:
                    self._entries = payload.get("entries", {})
            except Exception as e:
                print(f"warning: ignoring bucket manifest {manifest_file}: "
                      f"{e}")

    @classmethod
    def for_dataset(cls, json_path) -> "ImageSizeManifest":
        if os.environ.get("VAE_TAGGER_NO_BUCKET_MANIFEST") == "1":
            return cls(None)
        return cls(os.path.abspath(str(json_path)) + ".bucket_manifest.json")

    @staticmethod
    def _stat_key(path) -> Optional[Tuple[int, int]]:
        try:
            st = os.stat(path)
            return st.st_mtime_ns, st.st_size
        except OSError:
            return None

    def lookup(self, path) -> Optional[Tuple[int, int]]:
        """The cached (width, height) if the file is unchanged, else None."""
        entry = self._entries.get(str(path))
        if entry is None:
            return None
        key = self._stat_key(path)
        if key is None or list(key) != entry[:2]:
            return None
        return int(entry[2]), int(entry[3])

    def record(self, path, size: Tuple[int, int]) -> None:
        key = self._stat_key(path)
        if key is None:
            return
        self._entries[str(path)] = [key[0], key[1], int(size[0]),
                                    int(size[1])]
        self._dirty = True

    def save(self) -> None:
        if not self.path or not self._dirty:
            return
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"version": self.VERSION,
                           "entries": self._entries}, f)
            os.replace(tmp, self.path)
            self._dirty = False
        except OSError as e:  # a read-only dataset directory
            print(f"warning: could not write bucket manifest {self.path}: "
                  f"{e}")
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _native_smart_resize(img: Image.Image, width: int, height: int,
                         crop_mode: str) -> Optional[np.ndarray]:
    """Crop + Lanczos through the native library; None to fall back to
    PIL.  'random' crop offsets are drawn here, as SmartResize draws
    them."""
    if not native.available():
        return None
    src = np.asarray(img, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        return None
    offset = (_random_offset(src.shape[1], src.shape[0], width, height)
              if crop_mode == "random" else (0, 0))
    try:
        return native.smart_resize(src, width, height, crop_mode, offset)
    except Exception:
        return None


def _native_decode_resize(path, width: int, height: int, crop_mode: str,
                          resample: str = "lanczos"):
    """One native call for decode + crop + resample of JPEG, PNG or WebP
    (by magic bytes).  (result or None, the file's bytes or None); the
    bytes spare the PIL fallback a second read."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        fmt = native.sniff_format(data)
        if fmt is None or fmt not in native.decode_formats():
            return None, data
        offset = (0, 0)
        if crop_mode == "random":
            oh, ow = native.image_info(data)
            offset = _random_offset(ow, oh, width, height)
        return native.decode_image_resize(
            data, width, height, crop_mode, offset,
            quality_factor=_jpeg_quality_factor(), resample=resample), data
    except Exception:
        return None, None


def decode_bytes_square(data: bytes, resolution: int) -> np.ndarray:
    """Raw image bytes -> (resolution, resolution, 3) uint8 by the square
    distorting BILINEAR transform: the native fused decode + resize where
    it takes the bytes, PIL otherwise.  The one bytes-level policy of the
    square file loader and the HTTP server; raises on undecodable bytes."""
    try:
        out = native.decode_image_resize(
            data, resolution, resolution, "distort",
            quality_factor=_jpeg_quality_factor(), resample="bilinear")
        if out is not None:
            return out
    except Exception:
        pass
    img = Image.open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img.resize((resolution, resolution), Image.BILINEAR),
                      dtype=np.uint8)


def load_and_transform_image(path, resolution: Optional[int] = None,
                             bucket: Optional[Tuple[int, int]] = None,
                             crop_mode: str = "center") -> np.ndarray:
    """Decode an image file for the model; HWC uint8 (normalization to
    [-1, 1] happens on the device, ops/image.py).

    - ``bucket`` given: SmartResize to (bucket_w, bucket_h), the training
      bucket mode, natively (the fused decode, else PIL's decode and the
      native Lanczos), PIL where the library is off;
    - else the square resize to (resolution, resolution)."""
    if bucket is None:
        with open(path, "rb") as f:
            return decode_bytes_square(f.read(), resolution)
    out, data = _native_decode_resize(path, bucket[0], bucket[1], crop_mode)
    if out is not None:
        return out
    img = Image.open(io.BytesIO(data) if data is not None
                     else path).convert("RGB")
    out = _native_smart_resize(img, bucket[0], bucket[1], crop_mode)
    if out is not None:
        return out
    return np.asarray(SmartResize(bucket[0], bucket[1], crop_mode)(img),
                      dtype=np.uint8)


def _check_even(resolution: int) -> None:
    if resolution % 2:
        raise ValueError(f"YUV 4:2:0 transfer needs an even resolution, "
                         f"got {resolution}")


def decode_bytes_square_yuv(data: bytes,
                            resolution: int) -> Tuple[np.ndarray, np.ndarray]:
    """Raw image bytes -> planar YUV 4:2:0 after the square transform:
    ((res, res) luma, (2, res/2, res/2) chroma) uint8.  ``resolution``
    must be even; raises on undecodable bytes."""
    _check_even(resolution)
    try:
        out = native.decode_image_resize_yuv420(
            data, resolution, resolution, "distort",
            quality_factor=_jpeg_quality_factor(), resample="bilinear")
        if out is not None:
            return out
    except Exception:
        pass
    return to_yuv420(decode_bytes_square(data, resolution))


def load_and_transform_image_yuv(path, resolution: int
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode an image file for the YUV wire format (the square
    transform): (Y, CbCr) planar 4:2:0 uint8, 1.5 bytes a pixel."""
    _check_even(resolution)
    with open(path, "rb") as f:
        return decode_bytes_square_yuv(f.read(), resolution)


def to_yuv420(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """HWC uint8 RGB -> (Y (H, W), CbCr (2, H/2, W/2)) planar 4:2:0 uint8;
    H and W must be even.  The trainers' YUV wire format keeps the RGB
    transform and converts its result (native.rgb_to_yuv420)."""
    return native.rgb_to_yuv420(rgb)


def dummy_image(width: int = 512, height: int = 512) -> np.ndarray:
    """Black placeholder for an unreadable image."""
    return np.zeros((height, width, 3), dtype=np.uint8)
