"""ctypes binding of the native image decode and resize (the port's copy of
``vae_tagger_tpu/native/__init__.py``; the sources beside it are copies of
that package's, so both give the same pixels for the same bytes).

Builds ``libvtnative.so`` from resize.cpp + decode.cpp with ``g++ -O3`` at
first use, into ``build/native/`` beside the package (``.gitignore`` lists
it), named by a hash of the sources, and exposes:

- :func:`smart_resize` -- SmartResize semantics (aspect-preserving crop +
  Lanczos-3 or bilinear resample);
- :func:`decode_jpeg_resize` / :func:`decode_png_resize` /
  :func:`decode_webp_resize` -- a format's decode fused with the crop and
  resize (JPEG with DCT-domain scaling when the target is much smaller than
  the source), and their ``_yuv420`` forms for the YUV 4:2:0 wire format;
- :func:`decode_image_resize` -- sniffs the magic bytes and dispatches to
  whichever fused decoder is built;
- :func:`image_info` -- (height, width) from the header.

The build degrades: JPEG+PNG+WebP -> JPEG only -> resize only -> PIL
everywhere, by which development libraries the host has.
:func:`available` and :func:`decode_formats` report what the loaded
library can do.  ``VAE_TAGGER_NATIVE_RESIZE=0`` turns all of it off,
``VAE_TAGGER_NATIVE_DECODE=0`` the decode alone.  Everything here is host
code; nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "resize.cpp"
_SRC_DECODE = _DIR / "decode.cpp"
BUILD_DIR = _DIR.parents[1] / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_CROP_MODES = {"center": 0, "top": 1, "bottom": 1, "left": 1, "right": 1,
               "random": 2, "distort": 3}
_FILTERS = {"lanczos": 0, "bilinear": 1}

_JPEG_MAGIC = b"\xff\xd8"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

# widest first; each rung drops the library the one before needed
_RUNGS = (
    ([_SRC_DECODE], ["-DVT_HAVE_PNG", "-DVT_HAVE_WEBP", "-ljpeg", "-lpng16",
                     "-lwebp"]),
    ([_SRC_DECODE], ["-ljpeg"]),
    ([], []),
)

_U8P = ctypes.POINTER(ctypes.c_uint8)


def sniff_format(data: bytes) -> Optional[str]:
    """'jpeg' | 'png' | 'webp' | None from the leading magic bytes."""
    if data[:2] == _JPEG_MAGIC:
        return "jpeg"
    if data[:8] == _PNG_MAGIC:
        return "png"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    return None


def library_path() -> Path:
    """Where the library of these sources is built."""
    h = hashlib.sha256()
    for src in (_SRC, _SRC_DECODE):
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvtnative-{h.hexdigest()[:16]}.so"


def _try_build(so: Path, extra_srcs, extra_flags) -> bool:
    """One rung: compile to a file of this process, then rename it into
    place, so concurrent first uses never load a half-written library."""
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = (["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o",
            str(tmp), str(_SRC)] + [str(s) for s in extra_srcs]
           + extra_flags)
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return True
    except Exception as e:
        detail = getattr(e, "stderr", b"")
        detail = detail.decode(errors="replace")[-500:] if detail else e
        print(f"native build failed ({' '.join(extra_flags) or 'resize-only'}"
              f"): {detail}")
        tmp.unlink(missing_ok=True)
        return False


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    if any(_try_build(so, srcs, flags) for srcs, flags in _RUNGS):
        return True
    print("native resize build failed (falling back to PIL)")
    return False


_DECODERS = {  # format -> (info symbol, decode symbol)
    "jpeg": ("vt_jpeg_info", "vt_jpeg_decode_resize"),
    "png": ("vt_png_info", "vt_png_decode_resize"),
    "webp": ("vt_webp_info", "vt_webp_decode_resize"),
}


def _declare(lib: ctypes.CDLL) -> None:
    """The C signatures of every symbol the library was built with."""
    i32p = ctypes.POINTER(ctypes.c_int)
    i, sz = ctypes.c_int, ctypes.c_size_t
    lib.vt_smart_resize_filter.restype = i
    lib.vt_smart_resize_filter.argtypes = [_U8P, i, i, _U8P, i, i, i, i, i,
                                           i]
    optional = {
        "vt_rgb_to_yuv420": [_U8P, i, i, _U8P, _U8P, _U8P],
        "vt_jpeg_decode_resize_yuv420": [_U8P, sz, _U8P, _U8P, _U8P, i, i,
                                         i, i, i, i, i],
        "vt_webp_decode_resize_yuv420": [_U8P, sz, _U8P, _U8P, _U8P, i, i,
                                         i, i, i, i],
    }
    for sym, argtypes in optional.items():
        if hasattr(lib, sym):
            getattr(lib, sym).restype = i
            getattr(lib, sym).argtypes = argtypes
    for fmt, (info_sym, dec_sym) in _DECODERS.items():
        if not hasattr(lib, dec_sym):
            continue
        info = getattr(lib, info_sym)
        info.restype = i
        info.argtypes = [_U8P, sz, i32p, i32p]
        dec = getattr(lib, dec_sym)
        dec.restype = i
        dec.argtypes = ([_U8P, sz, _U8P, i, i, i, i, i]
                        + ([i, i] if fmt == "jpeg" else []) + [i])


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("VAE_TAGGER_NATIVE_RESIZE", "1") == "0":
            return None
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            _lib = lib
        except OSError as e:
            print(f"native resize load failed (falling back to PIL): {e}")
            _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def smart_resize(src: np.ndarray, target_width: int, target_height: int,
                 crop_mode: str = "center",
                 crop_offset: tuple[int, int] = (0, 0),
                 resample: str = "lanczos") -> np.ndarray:
    """Aspect-preserving crop + resample of an HWC uint8 RGB array;
    ``resample`` 'lanczos' (SmartResize) or 'bilinear' (the square
    inference transform, with crop_mode='distort')."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native resize library unavailable")
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {src.shape}")
    dst = np.empty((target_height, target_width, 3), dtype=np.uint8)
    rc = lib.vt_smart_resize_filter(
        src.ctypes.data_as(_U8P), src.shape[0], src.shape[1],
        dst.ctypes.data_as(_U8P), target_height, target_width,
        _CROP_MODES.get(crop_mode, 0), crop_offset[0], crop_offset[1],
        _FILTERS[resample])
    if rc != 0:
        raise RuntimeError(f"vt_smart_resize failed with code {rc}")
    return dst


def decode_formats() -> frozenset:
    """The image formats the loaded library decodes natively."""
    lib = _load()
    if lib is None or os.environ.get("VAE_TAGGER_NATIVE_DECODE", "1") == "0":
        return frozenset()
    return frozenset(f for f, (_, dec) in _DECODERS.items()
                     if hasattr(lib, dec))


def decode_available(fmt: str = "jpeg") -> bool:
    return fmt in decode_formats()


def _buffer(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)


def _info(fmt: str, data: bytes) -> tuple[int, int]:
    lib = _load()
    if lib is None or not hasattr(lib, _DECODERS[fmt][0]):
        raise RuntimeError(f"native {fmt} decoder unavailable")
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, _DECODERS[fmt][0])(_buffer(data), len(data),
                                         ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise RuntimeError(f"vt_{fmt}_info failed with code {rc}")
    return h.value, w.value


def image_info(data: bytes) -> tuple[int, int]:
    """(height, width) from any supported format's header."""
    fmt = sniff_format(data)
    if fmt is None:
        raise RuntimeError("unrecognized image format")
    return _info(fmt, data)


def _decode_resize(fmt: str, data: bytes, target_width: int,
                   target_height: int, crop_mode: str,
                   crop_offset: tuple[int, int], quality_factor: int,
                   reject_full_scale: bool,
                   resample: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None or not hasattr(lib, _DECODERS[fmt][1]):
        raise RuntimeError(f"native {fmt} decoder unavailable")
    dst = np.empty((target_height, target_width, 3), dtype=np.uint8)
    args = [_buffer(data), len(data), dst.ctypes.data_as(_U8P),
            target_height, target_width, _CROP_MODES.get(crop_mode, 0),
            crop_offset[0], crop_offset[1]]
    if fmt == "jpeg":
        args += [quality_factor, int(reject_full_scale)]
    args += [_FILTERS[resample]]
    rc = getattr(lib, _DECODERS[fmt][1])(*args)
    if rc == 1:
        return None
    if rc != 0:
        raise RuntimeError(f"{_DECODERS[fmt][1]} failed with code {rc}")
    return dst


def decode_jpeg_resize(data: bytes, target_width: int, target_height: int,
                       crop_mode: str = "center",
                       crop_offset: tuple[int, int] = (0, 0),
                       quality_factor: int = 2,
                       reject_full_scale: bool = False,
                       resample: str = "lanczos") -> Optional[np.ndarray]:
    """JPEG decode + SmartResize in one native call.

    ``quality_factor`` q > 0 lets libjpeg decode at a reduced DCT scale as
    long as the crop window stays >= q x the target on both axes (q=0
    forces a full decode).  ``crop_offset`` for 'random' mode is in
    full-resolution coordinates.  With ``reject_full_scale`` the call
    returns None, without decoding, when DCT scaling cannot engage; q=0
    overrides it."""
    return _decode_resize("jpeg", data, target_width, target_height,
                          crop_mode, crop_offset, quality_factor,
                          reject_full_scale, resample)


def decode_png_resize(data: bytes, target_width: int, target_height: int,
                      crop_mode: str = "center",
                      crop_offset: tuple[int, int] = (0, 0),
                      resample: str = "lanczos") -> Optional[np.ndarray]:
    """PNG decode + crop + resize in one native call (alpha dropped, PIL
    ``convert("RGB")`` semantics).  None for 16-bit PNGs: libpng's 8-bit
    conversion is a gamma encode, not PIL's bit-depth reduction, so those
    go to PIL."""
    return _decode_resize("png", data, target_width, target_height,
                          crop_mode, crop_offset, 0, False, resample)


def decode_webp_resize(data: bytes, target_width: int, target_height: int,
                       crop_mode: str = "center",
                       crop_offset: tuple[int, int] = (0, 0),
                       resample: str = "lanczos") -> np.ndarray:
    """WebP decode + crop + resize in one native call (alpha dropped)."""
    return _decode_resize("webp", data, target_width, target_height,
                          crop_mode, crop_offset, 0, False, resample)


def rgb_to_yuv420(rgb: np.ndarray):
    """HWC uint8 RGB -> (Y (H, W), CbCr (2, H/2, W/2)) planar 4:2:0:
    BT.601 full range with 2x2 box-averaged chroma; H and W even.  The
    native converter when built, else ops/image.py's numpy reference (the
    same math; rounding may differ by one step at .5)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    h, w = rgb.shape[:2]
    if h % 2 or w % 2:
        raise ValueError(f"YUV 4:2:0 needs even dims, got {h}x{w}")
    lib = _load()
    if lib is not None and hasattr(lib, "vt_rgb_to_yuv420"):
        y = np.empty((h, w), np.uint8)
        cbcr = np.empty((2, h // 2, w // 2), np.uint8)
        rc = lib.vt_rgb_to_yuv420(
            rgb.ctypes.data_as(_U8P), h, w, y.ctypes.data_as(_U8P),
            cbcr[0].ctypes.data_as(_U8P), cbcr[1].ctypes.data_as(_U8P))
        if rc == 0:
            return y, cbcr
    from ..ops.image import rgb_to_yuv420_reference

    return rgb_to_yuv420_reference(rgb)


def _yuv_planes(target_height: int, target_width: int):
    if target_height % 2 or target_width % 2:
        raise ValueError(
            f"YUV 4:2:0 needs even target dims, got "
            f"{target_height}x{target_width}")
    return (np.empty((target_height, target_width), np.uint8),
            np.empty((2, target_height // 2, target_width // 2), np.uint8))


def decode_jpeg_resize_yuv420(data: bytes, target_width: int,
                              target_height: int, crop_mode: str = "center",
                              crop_offset: tuple[int, int] = (0, 0),
                              quality_factor: int = 2,
                              resample: str = "lanczos"):
    """JPEG decode + SmartResize straight to planar YUV 4:2:0, without
    libjpeg's YCbCr->RGB conversion, chroma resampled to half the target.
    (Y, CbCr), or None when the file is not YCbCr (RGB/CMYK JPEGs: the
    caller decodes RGB and converts) or the decoder is not built."""
    lib = _load()
    if lib is None or not hasattr(lib, "vt_jpeg_decode_resize_yuv420"):
        return None
    y, cbcr = _yuv_planes(target_height, target_width)
    rc = lib.vt_jpeg_decode_resize_yuv420(
        _buffer(data), len(data), y.ctypes.data_as(_U8P),
        cbcr[0].ctypes.data_as(_U8P), cbcr[1].ctypes.data_as(_U8P),
        target_height, target_width, _CROP_MODES.get(crop_mode, 0),
        crop_offset[0], crop_offset[1], quality_factor, _FILTERS[resample])
    if rc == 2:
        return None  # unsupported JPEG colorspace: the RGB path
    if rc != 0:
        raise RuntimeError(f"vt_jpeg_decode_resize_yuv420 failed: {rc}")
    return y, cbcr


def decode_webp_resize_yuv420(data: bytes, target_width: int,
                              target_height: int, crop_mode: str = "center",
                              crop_offset: tuple[int, int] = (0, 0),
                              resample: str = "lanczos"):
    """Lossy-WebP decode + SmartResize straight to planar YUV 4:2:0 (the
    coded VP8 planes resampled and range-expanded to full range).  (Y,
    CbCr), or None for a lossless or animated file (the caller decodes RGB
    and converts) or when the decoder is not built."""
    lib = _load()
    if lib is None or not hasattr(lib, "vt_webp_decode_resize_yuv420"):
        return None
    y, cbcr = _yuv_planes(target_height, target_width)
    rc = lib.vt_webp_decode_resize_yuv420(
        _buffer(data), len(data), y.ctypes.data_as(_U8P),
        cbcr[0].ctypes.data_as(_U8P), cbcr[1].ctypes.data_as(_U8P),
        target_height, target_width, _CROP_MODES.get(crop_mode, 0),
        crop_offset[0], crop_offset[1], _FILTERS[resample])
    if rc == 2:
        return None  # lossless/animated: the RGB path
    if rc != 0:
        raise RuntimeError(f"vt_webp_decode_resize_yuv420 failed: {rc}")
    return y, cbcr


def decode_image_resize_yuv420(data: bytes, target_width: int,
                               target_height: int, crop_mode: str = "center",
                               crop_offset: tuple[int, int] = (0, 0),
                               quality_factor: int = 2,
                               resample: str = "lanczos"):
    """Any supported format -> planar YUV 4:2:0 (Y, CbCr), or None when no
    native decoder takes these bytes (the caller decodes with PIL and
    converts with :func:`rgb_to_yuv420`).  JPEGs and lossy WebPs go
    straight to their coded planes; PNG and lossless WebP decode to RGB
    and convert."""
    fmt = sniff_format(data)
    if fmt == "jpeg" and decode_available("jpeg"):
        out = decode_jpeg_resize_yuv420(data, target_width, target_height,
                                        crop_mode, crop_offset,
                                        quality_factor, resample)
        if out is not None:
            return out
    if fmt == "webp" and decode_available("webp"):
        out = decode_webp_resize_yuv420(data, target_width, target_height,
                                        crop_mode, crop_offset, resample)
        if out is not None:
            return out
    rgb = decode_image_resize(data, target_width, target_height, crop_mode,
                              crop_offset, quality_factor, False, resample)
    if rgb is None:
        return None
    return rgb_to_yuv420(rgb)


def decode_image_resize(data: bytes, target_width: int, target_height: int,
                        crop_mode: str = "center",
                        crop_offset: tuple[int, int] = (0, 0),
                        quality_factor: int = 2,
                        reject_full_scale: bool = False,
                        resample: str = "lanczos") -> Optional[np.ndarray]:
    """Sniff the format and decode+resize in one native call; None when
    the format is not decoded natively (the caller falls back to PIL) or
    a JPEG's ``reject_full_scale`` fires."""
    fmt = sniff_format(data)
    if fmt is None or fmt not in decode_formats():
        return None
    return _decode_resize(fmt, data, target_width, target_height, crop_mode,
                          crop_offset, quality_factor, reject_full_scale,
                          resample)
