"""Tiled VAE encode and decode at any resolution (the port's copy of
``vae_tagger_tpu/infer/tiled.py``).

The VAE runs over fixed-shape overlapping tiles, ``batch_tiles`` tiles a
call, and the overlaps are blended on the host in fp32 with trapezoid
ramps, so an image of any size needs the device memory of one tile batch.
The tail call is filled up with copies of the first tile: the result does
not change, only the shapes a call sees stay fixed.

GroupNorm statistics are taken per tile, not over the whole image, so
outputs near tile interiors differ slightly from a direct pass; the
overlap ramps hide the seams.  The blend itself is exact: for any
shift-invariant op whose receptive field fits in the overlap, tiled equals
direct.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch


def tile_starts(size: int, tile: int, stride: int) -> List[int]:
    """Tile origins covering [0, size) at a uniform stride, the last one
    clamped to end exactly at ``size`` (every tile keeps one shape)."""
    if size <= tile:
        return [0]
    n = math.ceil((size - tile) / stride) + 1
    return sorted({min(i * stride, size - tile) for i in range(n)})


def _axis_weights(start: int, tile: int, size: int, ramp: int) -> np.ndarray:
    """Blend weights of one tile along one axis: linear ramps of ``ramp``
    samples at edges that meet a neighbouring tile, flat 1 at the image's
    borders.  The accumulator divides by the summed weights."""
    w = np.ones(tile, dtype=np.float32)
    r = np.arange(1, ramp + 1, dtype=np.float32) / (ramp + 1)
    if start > 0 and ramp:
        w[:ramp] = r
    if start + tile < size and ramp:
        w[-ramp:] = r[::-1]
    return w


def tiled_apply(x: np.ndarray, tile: int, overlap: int, out_scale: float,
                out_channels: int, apply_chunk: Callable,
                batch_tiles: int = 8) -> np.ndarray:
    """Run ``apply_chunk`` over overlapping tiles of ``x`` and blend.

    Args:
      x: (H, W, C_in) array (uint8 pixels to encode, float latents to
        decode), at least one tile in each dimension (callers pad).
      tile / overlap: tile extent and neighbour overlap in input samples.
      out_scale: output samples per input sample (1/8 encode, 8 decode).
      out_channels: channels of the output.
      apply_chunk: (batch_tiles, tile, tile, C_in) -> (batch_tiles, t_out,
        t_out, out_channels), any array type numpy can read.
      batch_tiles: tiles a call.

    Returns (H * out_scale, W * out_scale, out_channels) float32.
    """
    if not 0 <= overlap < tile:
        raise ValueError(f"need 0 <= overlap < tile, got {overlap}/{tile}")
    h, w = x.shape[:2]
    stride = tile - overlap
    rows = tile_starts(h, tile, stride)
    cols = tile_starts(w, tile, stride)
    if h < tile or w < tile:
        raise ValueError(f"input {h}x{w} smaller than tile {tile}; pad first")

    tiles = np.stack([x[r:r + tile, c:c + tile] for r in rows for c in cols])
    n = len(tiles)
    pad = -n % batch_tiles
    if pad:  # copies of the first tile keep the tail call's shape
        tiles = np.concatenate([tiles, tiles[:1].repeat(pad, 0)])
    outs = np.concatenate([
        np.asarray(apply_chunk(tiles[i:i + batch_tiles]), dtype=np.float32)
        for i in range(0, len(tiles), batch_tiles)])[:n]

    def s(v: int) -> int:
        o = v * out_scale
        assert o == int(o), (v, out_scale)
        return int(o)

    t_out = s(tile)
    if outs.shape[1:3] != (t_out, t_out):
        raise ValueError(f"apply_chunk returned {outs.shape[1:3]}, "
                         f"expected {(t_out, t_out)}")
    acc = np.zeros((s(h), s(w), out_channels), dtype=np.float32)
    wacc = np.zeros((s(h), s(w), 1), dtype=np.float32)
    k = 0
    for r in rows:
        wr = _axis_weights(s(r), t_out, s(h), s(overlap))
        for c in cols:
            wc = _axis_weights(s(c), t_out, s(w), s(overlap))
            wt = np.outer(wr, wc)[..., None]
            acc[s(r):s(r) + t_out, s(c):s(c) + t_out] += outs[k] * wt
            wacc[s(r):s(r) + t_out, s(c):s(c) + t_out] += wt
            k += 1
    return acc / wacc


def _pad_to(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge-replicating padding (zeros would bleed black into the border
    tiles' GroupNorm statistics)."""
    return np.pad(x, ((0, h - x.shape[0]), (0, w - x.shape[1]), (0, 0)),
                  mode="edge")


class TiledVAE:
    """Encode and decode at any resolution over fixed-shape tiles of the
    port's ``AutoencoderKL`` (its decoder is needed for :meth:`decode`).

    ``tile`` and ``overlap`` are in pixels and must be multiples of the
    VAE's downsample factor (8), so the pixel and latent tile grids align.
    Each call runs under ``torch.inference_mode()`` on the VAE's device
    (the CUDA kernels on the card) in ``compute_dtype``."""

    def __init__(self, vae, tile: int = 1024, overlap: int = 256,
                 batch_tiles: int = 8, compute_dtype=torch.float32):
        f = vae.config.downsample_factor
        if tile % f or overlap % f:
            raise ValueError(f"tile/overlap must be multiples of the "
                             f"downsample factor {f}; got {tile}/{overlap}")
        self.vae = vae
        self.tile, self.overlap = tile, overlap
        self.batch_tiles = batch_tiles
        self.f = f
        self.compute_dtype = compute_dtype

    @property
    def device(self) -> torch.device:
        return next(self.vae.parameters()).device

    def _encode_chunk(self, px_u8: np.ndarray) -> np.ndarray:
        from ..ops.image import normalize_uint8

        with torch.inference_mode():
            px = torch.from_numpy(np.ascontiguousarray(px_u8)).to(
                self.device)
            posterior = self.vae.encode(normalize_uint8(px,
                                                        self.compute_dtype))
            z = self.vae.scale_latents(posterior.mode())
            return z.float().cpu().numpy()

    def _decode_chunk(self, z_scaled: np.ndarray) -> np.ndarray:
        from ..models.autoencoder_kl import decode_scaled

        with torch.inference_mode():
            z = torch.from_numpy(np.ascontiguousarray(z_scaled)).to(
                self.device)
            z = decode_scaled(z.float(), self.vae.config)
            return self.vae.decode(z, self.compute_dtype).cpu().numpy()

    def encode(self, pixels_u8: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> (ceil(H/8), ceil(W/8), C) fp32 scaled
        latents (the engine's scale and shift)."""
        h, w = pixels_u8.shape[:2]
        hp = max(self.tile, -(-h // self.f) * self.f)
        wp = max(self.tile, -(-w // self.f) * self.f)
        x = _pad_to(np.asarray(pixels_u8), hp, wp)
        z = tiled_apply(x, self.tile, self.overlap, 1 / self.f,
                        self.vae.config.latent_channels, self._encode_chunk,
                        self.batch_tiles)
        return z[:-(-h // self.f), :-(-w // self.f)]

    def decode(self, latents: np.ndarray) -> np.ndarray:
        """(h, w, C) scaled latents -> (8h, 8w, 3) fp32 in [-1, 1]."""
        h, w = latents.shape[:2]
        tl, ov = self.tile // self.f, self.overlap // self.f
        z = _pad_to(np.asarray(latents, np.float32), max(tl, h), max(tl, w))
        px = tiled_apply(z, tl, ov, self.f, 3, self._decode_chunk,
                         self.batch_tiles)
        return px[:h * self.f, :w * self.f]
