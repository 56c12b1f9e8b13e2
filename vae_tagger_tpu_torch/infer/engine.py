"""Model loading and the batched encode/classify engine.

Counterpart of ``vae_tagger_tpu/infer/engine.py``.  The engine loads the
same checkpoint formats (VAE safetensors/bin + config JSON, decoder
``pytorch_model.bin``) and runs uint8 pixels -> on-device normalize -> VAE
encode (the CUDA kernels on the card) -> posterior mode -> scale/shift ->
tagger head -> sigmoid, under ``torch.inference_mode()``.

- The host->device copy of a uint8 batch is non-blocking, from pinned
  memory, on the current stream.
- :meth:`TaggerEngine.classify_async` and
  :meth:`VAEOnlyEngine.encode_async` return the device tensor without
  synchronizing, so the caller can format the previous batch meanwhile.
- :class:`VAEOnlyEngine`, the base of :class:`TaggerEngine`, holds the
  encode half of the VAE alone (latent extraction); neither loads the VAE
  decoder onto the card.
- The VAE and the tagger head run in the policy's compute dtype (bf16
  with mixed precision), the head fed the latents cast to it, as the JAX
  engine does; the probabilities are the sigmoid of the logits in fp32.
- :meth:`TaggerEngine.get_attention_maps` returns the head's CBAM gates
  and softmax weights for a pixel batch (models/taggers.py).
- The ``*_yuv*`` methods take the YUV 4:2:0 wire format, a (B, H, W)
  luma plane and (B, 2, H/2, W/2) chroma, half of RGB's bytes; the card
  turns them back into uint8 RGB (ops/image.py) before the same encode.

- :meth:`VAEOnlyEngine.with_devices` (the JAX engine's ``with_mesh``)
  returns a copy holding one replica of the models per device (a device
  may repeat: two replicas on one card); its ``encode_async``,
  ``classify_async`` and their YUV forms pad the batch with zero rows to
  a multiple of the replicas, give each replica its contiguous chunk,
  launch every chunk before reading any result, and drop the pad rows
  (the VAE's GroupNorm and the eval-mode head are per sample, so pads
  cannot touch real rows).  The results come back concatenated on the
  first replica's device.

- :meth:`VAEOnlyEngine.with_spatial` (the JAX engine's
  ``with_spatial_mesh``) returns a copy that cuts each image's height into
  slabs over a list of devices (parallel/spatial.py; a device may repeat)
  and runs the VAE body on them, latency mode: a lone image uses every
  device.  With ``data_ways`` > 1 the devices form that many rows (the JAX
  grid's ``data`` axis), the batch is padded with zero rows to a multiple
  of the rows and each row takes its contiguous chunk; in pure spatial
  mode the batch is not padded.  The moments come back to the engine's
  device, where the head runs on the whole batch.  Heights not divisible
  by the downsample factor times the shards are refused, and so are the
  YUV methods, as in the JAX package.

While a profiler runs, placing a batch (the pinned staging copy and the
host-to-device copy queued) is the span ``engine.place``, named
``vt:engine.place`` in the trace (utils/profiling.py).

The TPU's padding of batches to 8 rows is not carried over.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..core.config import AttentionDecoderConfig
from ..core.device import indexed_device, resolve_device
from ..core.precision import Policy, resolve_mixed_precision
from ..data.dataset import load_tag_names
from ..io.checkpoints import load_decoder, load_vae
from ..models.autoencoder_kl import AutoencoderKL
from ..models.taggers import (
    AttentionClassificationDecoder,
    ClassificationDecoder,
    get_attention_maps,
)
from ..nn.blocks import seeded_init_
from ..ops.image import normalize_uint8, yuv420_to_rgb_uint8
from ..parallel.spatial import SpatialMesh
from ..utils.profiling import ranged


def build_decoder(num_classes: int, use_attention: bool = True,
                  attention_config: Optional[dict] = None,
                  latent_channels: int = 16, seed: int = 0,
                  dtype=torch.float32):
    """Decoder factory of the reference's inference script; ``dtype`` is
    the head's compute dtype (the policy's)."""
    if use_attention:
        cfg = AttentionDecoderConfig(**(attention_config or {}))
        head = AttentionClassificationDecoder(latent_channels, num_classes,
                                              cfg, dtype)
    else:
        head = ClassificationDecoder(latent_channels, num_classes, dtype)
    return seeded_init_(head, seed)


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """``a`` with zero rows appended up to ``rows``."""
    a = np.asarray(a)
    if len(a) == rows:
        return a
    pad = np.zeros((rows - len(a), *a.shape[1:]), a.dtype)
    return np.concatenate([a, pad])


class VAEOnlyEngine:
    """The encode half of the VAE on one device: uint8 pixels -> scaled
    posterior-mode latents (latent extraction, and the base of
    :class:`TaggerEngine`).  The VAE decoder is not loaded."""

    # the modules a replica holds on its device (with_devices)
    _MODULES = ("vae",)
    replicas = None
    spatial = None

    def __init__(self, vae: AutoencoderKL, policy: Policy = Policy(),
                 device=None):
        self.device = resolve_device(device)
        self.policy = policy
        self.vae = vae.to(self.device).eval()

    def with_devices(self, devices) -> "VAEOnlyEngine":
        """A copy of this engine with one replica of its models on each of
        ``devices``, over which the ``*_async`` methods split every
        batch."""
        own = indexed_device(self.device)
        moved = {}
        replicas = []
        for device in (indexed_device(d) for d in devices):
            replica = copy.copy(self)
            replica.device, replica.replicas = device, None
            for name in self._MODULES:
                if (name, device) not in moved:
                    module = getattr(self, name)
                    moved[name, device] = (
                        module if device == own
                        else copy.deepcopy(module).to(device))
                setattr(replica, name, moved[name, device])
            replicas.append(replica)
        engine = copy.copy(self)
        engine.replicas = replicas
        return engine

    def with_spatial(self, devices, data_ways: int = 1) -> "VAEOnlyEngine":
        """A copy of this engine that shards each image's height over
        ``devices`` (``data_ways`` rows of them, each row a batch chunk's
        slabs), its models on ``devices[0]``."""
        mesh = SpatialMesh(devices, data_ways)
        engine = copy.copy(self)
        engine.spatial, engine.replicas = mesh, None
        engine.device = mesh.devices[0]
        if engine.device != indexed_device(self.device):
            for name in self._MODULES:
                setattr(engine, name,
                        copy.deepcopy(getattr(self, name)).to(engine.device))
        return engine

    def _refuse_yuv(self):
        if self.spatial is not None:
            raise NotImplementedError(
                "YUV transfer is not supported with spatial parallelism")

    def _split(self, method: str, *arrays):
        """``method`` of every replica on its contiguous chunk of the batch,
        padded with zero rows to a multiple of the replicas; every chunk
        is launched before any result is read.  Returns (the results
        without the pad rows, on the first replica's device, real
        count)."""
        n, b = len(self.replicas), len(arrays[0])
        per = -(-b // n)
        arrays = [_pad_rows(a, per * n) for a in arrays]
        outs = [getattr(r, method)(*(a[i * per:(i + 1) * per]
                                     for a in arrays))[0]
                for i, r in enumerate(self.replicas)]
        first = self.replicas[0].device
        with torch.inference_mode():
            return torch.cat([o.to(first, non_blocking=True)
                              for o in outs])[:b], b

    @classmethod
    def load(cls, vae_checkpoint: str,
             vae_config_path: Optional[str] = None,
             mixed_precision: Optional[str] = None,
             device=None) -> "VAEOnlyEngine":
        device = resolve_device(device)
        return cls(load_vae(vae_checkpoint, vae_config_path),
                   resolve_mixed_precision(mixed_precision), device)

    def _to_device(self, host) -> torch.Tensor:
        """Host uint8 array -> device tensor (pinned, non-blocking)."""
        arr = np.ascontiguousarray(host)
        if not arr.flags.writeable:
            arr = arr.copy()
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    @ranged("engine.place")
    def _place(self, pixels_uint8) -> torch.Tensor:
        """Host uint8 batch -> device tensor (pinned, non-blocking)."""
        return self._to_device(pixels_uint8)

    def _encode(self, px: torch.Tensor) -> torch.Tensor:
        x = normalize_uint8(px, self.policy.compute_dtype)
        if self.spatial is None:
            mode = self.vae.encode(x).mode()
        else:  # each data row encodes its chunk over its slabs
            rows = self.spatial.rows()
            mode = torch.cat([self.vae.encode(chunk, spatial=row).mode()
                              for chunk, row in zip(x.chunk(len(rows)),
                                                    rows)])
        return self.vae.scale_latents(mode)

    def _placed(self, pixels_uint8) -> torch.Tensor:
        """The batch on the device.  In spatial mode a height the shards do
        not split is refused first, and the batch is padded with zero rows
        to a multiple of the data rows."""
        if self.spatial is None:
            return self._place(pixels_uint8)
        self.spatial.check_height(np.shape(pixels_uint8)[1],
                                  self.vae.config.downsample_factor)
        rows = self.spatial.data_ways
        return self._place(_pad_rows(pixels_uint8,
                                     -(-len(pixels_uint8) // rows) * rows))

    def encode_async(self, pixels_uint8: np.ndarray):
        """Dispatch without synchronizing: (device latents, real count)."""
        if self.replicas:
            return self._split("encode_async", pixels_uint8)
        b = len(pixels_uint8)
        with torch.inference_mode():
            latents = self._encode(self._placed(pixels_uint8))[:b]
        return latents, b

    def encode(self, pixels_uint8: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, h, w, C) scaled/shifted latents."""
        latents, _ = self.encode_async(pixels_uint8)
        return latents.float().cpu().numpy()

    @ranged("engine.place")
    def _place_yuv(self, y_uint8, cbcr_uint8) -> torch.Tensor:
        """Host (Y, CbCr) planes -> device uint8 RGB."""
        return yuv420_to_rgb_uint8(self._to_device(y_uint8),
                                   self._to_device(cbcr_uint8))

    def encode_yuv_async(self, y_uint8: np.ndarray, cbcr_uint8: np.ndarray):
        """:meth:`encode_async` of the YUV 4:2:0 planes."""
        self._refuse_yuv()
        if self.replicas:
            return self._split("encode_yuv_async", y_uint8, cbcr_uint8)
        with torch.inference_mode():
            latents = self._encode(self._place_yuv(y_uint8, cbcr_uint8))
        return latents, len(y_uint8)

    def encode_yuv(self, y_uint8: np.ndarray,
                   cbcr_uint8: np.ndarray) -> np.ndarray:
        latents, _ = self.encode_yuv_async(y_uint8, cbcr_uint8)
        return latents.float().cpu().numpy()


class TaggerEngine(VAEOnlyEngine):
    """VAE encoder + tagger head on one device; the head runs in the
    policy's compute dtype."""

    _MODULES = ("vae", "decoder")

    def __init__(self, vae: AutoencoderKL, decoder: torch.nn.Module,
                 tag_names: list, policy: Policy = Policy(),
                 device=None):
        super().__init__(vae, policy, device)
        self.decoder = decoder.to(self.device).eval()
        self.decoder.dtype = policy.compute_dtype
        self.tag_names = tag_names

    @classmethod
    def load(cls, vae_checkpoint: str, decoder_checkpoint: str,
             tags_csv_path: str, vae_config_path: Optional[str] = None,
             use_attention: bool = True,
             attention_config: Optional[dict] = None,
             mixed_precision: Optional[str] = None,
             device=None) -> "TaggerEngine":
        """Load both checkpoints.  ``device`` defaults to ``cuda`` and
        raises on a host without one; pass ``"cpu"`` for the plain path."""
        device = resolve_device(device)
        policy = resolve_mixed_precision(mixed_precision)
        vae = load_vae(vae_checkpoint, vae_config_path)
        tag_names = load_tag_names(tags_csv_path)
        decoder = build_decoder(len(tag_names), use_attention,
                                attention_config,
                                latent_channels=vae.config.latent_channels,
                                dtype=policy.compute_dtype)
        load_decoder(decoder, decoder_checkpoint)
        return cls(vae, decoder, tag_names, policy, device)

    def _encode_classify(self, px: torch.Tensor):
        latents = self._encode(px)
        logits = self.decoder(latents.to(self.policy.compute_dtype))
        return latents, torch.sigmoid(logits.float())

    def classify_async(self, pixels_uint8: np.ndarray):
        """Dispatch without synchronizing: (device_probs, real_count)."""
        if self.replicas:
            return self._split("classify_async", pixels_uint8)
        b = len(pixels_uint8)
        with torch.inference_mode():
            _, probs = self._encode_classify(self._placed(pixels_uint8))
        return probs[:b], b

    def classify(self, pixels_uint8: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, num_tags) sigmoid probabilities."""
        probs, _ = self.classify_async(pixels_uint8)
        return probs.cpu().numpy()

    def classify_yuv_async(self, y_uint8: np.ndarray,
                           cbcr_uint8: np.ndarray):
        """:meth:`classify_async` of the YUV 4:2:0 planes."""
        self._refuse_yuv()
        if self.replicas:
            return self._split("classify_yuv_async", y_uint8, cbcr_uint8)
        with torch.inference_mode():
            _, probs = self._encode_classify(
                self._place_yuv(y_uint8, cbcr_uint8))
        return probs, len(y_uint8)

    def classify_yuv(self, y_uint8: np.ndarray,
                     cbcr_uint8: np.ndarray) -> np.ndarray:
        probs, _ = self.classify_yuv_async(y_uint8, cbcr_uint8)
        return probs.cpu().numpy()

    def encode_and_classify(self, pixels_uint8: np.ndarray):
        b = len(pixels_uint8)
        with torch.inference_mode():
            latents, probs = self._encode_classify(
                self._placed(pixels_uint8))
        return latents[:b].float().cpu().numpy(), probs[:b].cpu().numpy()

    def get_attention_maps(self, pixels_uint8: np.ndarray) -> dict:
        """The head's attention maps for a uint8 pixel batch
        (models/taggers.py::get_attention_maps), as fp32 numpy arrays;
        the head runs in the compute dtype, as in :meth:`classify`."""
        b = len(pixels_uint8)
        with torch.inference_mode():
            latents = self._encode(self._placed(pixels_uint8))[:b]
            maps = get_attention_maps(
                self.decoder, latents.to(self.policy.compute_dtype))
        return {k: v.float().cpu().numpy() for k, v in maps.items()}

    def get_confidence(self, pixels_uint8: np.ndarray):
        """Descending (confidences, indices) per image."""
        probs = self.classify(pixels_uint8)
        indices = np.argsort(-probs, axis=-1, kind="stable")
        return np.take_along_axis(probs, indices, axis=-1), indices
