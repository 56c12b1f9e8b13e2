"""Height-sharded spatial parallelism in one process (the port's
counterpart of ``shard_batch_spatial`` in ``vae_tagger_tpu/parallel/
mesh.py``, of the spatial context of ``vae_tagger_tpu/ops/attention.py``
and of ``spatial_parallel_enabled`` and ``validate_spatial_resolutions``
in ``vae_tagger_tpu/train/loop.py``).

One controller drives a list of devices, as the JAX package's single
program does: each image's height is cut into ``n`` equal slabs, each slab
a tensor on its own device, and one host thread launches the work of every
slab.  A device may repeat (``[cuda:0, cuda:0]`` is two slabs on one card,
``[cpu] * n`` the same on the CPU).  What GSPMD inserts for the JAX
package is written out here, from differentiable ``.to(device)`` and
``torch.cat``, so autograd gives every backward: the halo exchange's, the
GroupNorm statistics' and the K/V gather's, whose dK and dV it sums over
the slabs:

- :func:`shard_height` and :func:`gather_height`;
- :func:`halo`: a slab extended by rows of the slab above and the slab
  below, with nothing at the true image edge (the convolution's own zero
  padding stays there), and :func:`crop` back to the slab's own rows;
- :func:`global_group_stats`: each slab's per-(sample, group) mean and
  E[x^2] over its own rows, moved to every device and averaged (the slabs
  have equal row counts);
- :func:`gathered_kv`: every slab's keys and values, in height order, on
  each slab's device.

The master parameters stay on the first device; a slab on another device
reads them through ``.to(device)`` (the same tensor on the same device),
so their gradients sum into the master ``.grad``.  Over more than one
process spatial sharding is refused (core/cli.py::refuse_unported), as in
the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..core.device import indexed_device
from ..ops.normalization import group_stats_with_grad
from . import mesh


class SpatialMesh:
    """``data_ways`` rows of ``shards`` devices: ``devices`` lists row 0's,
    then row 1's.  A batch splits over the rows (the JAX mesh's ``data``
    axis), each image's height over the devices of its row (``model``)."""

    def __init__(self, devices: Sequence, data_ways: int = 1):
        self.devices = [indexed_device(d) for d in devices]
        if data_ways < 1 or not self.devices or (
                len(self.devices) % data_ways):
            raise ValueError(f"{len(self.devices)} devices do not split "
                             f"into {data_ways} rows")
        self.data_ways = data_ways
        self.shards = len(self.devices) // data_ways

    def rows(self) -> List["SpatialMesh"]:
        """One mesh of ``shards`` devices a data row."""
        s = self.shards
        return [SpatialMesh(self.devices[r * s:(r + 1) * s])
                for r in range(self.data_ways)]

    def check_height(self, height: int, downsample: int) -> None:
        """Raise unless every stage of the encoder keeps whole, even slabs:
        H divisible by the downsample factor times the shards."""
        need = downsample * self.shards
        if height % need:
            raise ValueError(
                f"spatial parallelism needs H divisible by {need} "
                f"(downsample {downsample} x {self.shards} shards), got "
                f"{height}")

    def __repr__(self):
        return (f"SpatialMesh({[str(d) for d in self.devices]}, "
                f"data_ways={self.data_ways})")


def shard_height(x: torch.Tensor, devices: Sequence) -> list:
    """NHWC x cut into ``len(devices)`` equal height slabs, slab i on
    devices[i]."""
    n = len(devices)
    if x.shape[1] % n:
        raise ValueError(f"spatial sharding needs the height "
                         f"({x.shape[1]}) divisible by {n} shards")
    return [s.to(d) for s, d in zip(x.chunk(n, dim=1), devices)]


def gather_height(xs: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The slabs put back together along the height, on ``device``."""
    return torch.cat([x.to(device) for x in xs], dim=1)


def halo(xs: Sequence[torch.Tensor], above: int = 1, below: int = 1):
    """Each slab extended by the last ``above`` rows of the slab above it
    and the first ``below`` rows of the slab below it, on its own device;
    the first slab gets nothing above, the last nothing below.  Returns
    (extended slabs, rows added on top of each)."""
    out, tops = [], []
    last = len(xs) - 1
    for i, x in enumerate(xs):
        parts = []
        if i > 0 and above:
            parts.append(xs[i - 1][:, -above:].to(x.device))
        parts.append(x)
        if i < last and below:
            parts.append(xs[i + 1][:, :below].to(x.device))
        out.append(torch.cat(parts, dim=1) if len(parts) > 1 else x)
        tops.append(above if i > 0 else 0)
    return out, tops


def crop(ys: Sequence[torch.Tensor], tops: Sequence[int], rows: int) -> list:
    """Rows [top, top + rows) of each extended output: its slab's own."""
    return [y[:, t:t + rows] for y, t in zip(ys, tops)]


def global_group_stats(xs: Sequence[torch.Tensor], num_groups: int) -> list:
    """(mean, E[x^2]) (N, G) fp32 of the whole image on each slab's device:
    every slab's statistics over its own rows (kernel A's stats pass on the
    card), moved to each device and averaged, with a gradient."""
    local = [group_stats_with_grad(x, num_groups) for x in xs]
    n = len(xs)
    out = []
    for x in xs:
        mean = sum(m.to(x.device) for m, _ in local) / n
        meansq = sum(q.to(x.device) for _, q in local) / n
        out.append((mean, meansq))
    return out


def gathered_kv(ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor]):
    """[(K, V)] with every slab's (B, S_i, D) keys and values concatenated
    in height order on each slab's device: the all-gather of the JAX
    package's spatial attention."""
    return [(torch.cat([k.to(q_dev) for k in ks], dim=1),
             torch.cat([v.to(q_dev) for v in vs], dim=1))
            for q_dev in (k.device for k in ks)]


def spatial_parallel_enabled(args, devices) -> bool:
    """True when this run shards each image's height over ``devices``:
    ``--spatial_parallel`` is set and there is more than one device.  On
    one device the flag is a no-op, as in the JAX package."""
    return bool(getattr(args, "spatial_parallel", False)) and len(devices) > 1


def trainer_mesh(args, downsample_factor: int):
    """The mesh a trainer's ``--spatial_parallel`` shards over: every local
    device of ``args.device`` (parallel/mesh.py::local_devices), after the
    resolutions are validated; None when the flag is off or there is one
    device."""
    devices = mesh.local_devices(args.device)
    if not spatial_parallel_enabled(args, devices):
        return None
    validate_spatial_resolutions(args, downsample_factor, len(devices))
    return SpatialMesh(devices)


def validate_spatial_resolutions(args, downsample_factor: int,
                                 n: int) -> None:
    """Every trained resolution must split evenly over ``n`` shards (H
    divisible by the downsample factor times n).  Bucketed runs make
    sizes base + k * step, so base and step divisible covers every
    bucket."""
    need = downsample_factor * n
    dims = ([args.base_resolution, args.bucket_step]
            if getattr(args, "use_bucketing", False) else [args.resolution])
    bad = [d for d in dims if d % need]
    if bad:
        raise ValueError(
            f"--spatial_parallel over {n} devices needs resolutions "
            f"divisible by {need} (downsample {downsample_factor} x {n} "
            f"shards); got {bad}")
    print(f"spatial-parallel training over {n} devices "
          f"(image height sharded; batch NOT multiplied)")
