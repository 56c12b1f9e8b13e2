"""Data parallelism over GPUs (the port's counterpart of
``vae_tagger_tpu/parallel/mesh.py``).

The JAX package runs SPMD programs over a device mesh: parameters
replicated, the batch sharded on a ``data`` axis, gradients averaged by
the all-reduces XLA inserts.  The port keeps those semantics in
PyTorch's idiom:

- the trainers run one process per GPU under ``torchrun``
  (:func:`initialize_distributed` reads its environment); every rank
  builds the same global batches and loads its contiguous slice of each
  (``data/loader.py``), the optimizer averages the gradients over the
  ranks with one all-reduce per update (``train/state.py``), and the
  terms of a step that mix samples see the global batch through the
  helpers below: :func:`global_sum` (the head's train-mode BatchNorm, the
  log-damped KL) and :func:`draw_global` (posterior and dropout noise).
  So a data-parallel step equals one process's step on the global batch;
- the infer, serve and eval CLIs, which run in one process, hold one
  engine replica per local GPU (``TaggerEngine.with_devices``) and split
  each batch over them (:func:`auto_data_parallel` picks the devices).

``process_index() == 0`` (:func:`is_main_process`) gates every file
write and log line, as ``jax.process_index() == 0`` does there.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import indexed_device

# torchrun's environment; all or none of it must be set
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")
# a peer that stops answering fails the collective after this long,
# instead of hanging the run
TIMEOUT = datetime.timedelta(minutes=10)

# the host-side group (gloo) of an NCCL run: flags and barriers that must
# not wait for the device's queue
_HOST_GROUP = None


def initialize_distributed(device=None) -> torch.device:
    """Join the process group torchrun describes; call it first in every
    trainer.  Returns this rank's device: ``cuda:LOCAL_RANK`` (also made
    the current device) on ``cuda``, ``device`` unchanged on the CPU.

    - With none of ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
      ``MASTER_ADDR``, ``MASTER_PORT`` set it does nothing (one process);
      with some but not all it raises: the peers would wait in the
      rendezvous while this process trained alone.
    - The backend is NCCL on ``cuda`` and gloo on the CPU.  Each process
      owns one GPU, so a ``LOCAL_RANK`` not below the device count is
      fatal.  A failed init raises; it never falls back to one process.
    - A group that already exists (a caller's own) is kept."""
    device = torch.device("cuda" if device is None else device)
    if dist.is_initialized():
        return indexed_device(device)
    present = [k for k in LAUNCHER_VARS if os.environ.get(k) is not None]
    if not present:
        return device
    missing = [k for k in LAUNCHER_VARS if k not in present]
    if missing:
        raise RuntimeError(
            f"{'/'.join(present)} set but not {'/'.join(missing)}: "
            "refusing to run single-process in a multi-process launcher "
            "environment; launch with torchrun or unset the variables")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    backend = "gloo"
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(
                f"LOCAL_RANK {local} but this host has {count} visible "
                "GPUs: each process owns one GPU; launch at most that many "
                "processes per host (torchrun --nproc_per_node)")
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
        backend = "nccl"
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        rank=rank, world_size=world, timeout=TIMEOUT)
    global _HOST_GROUP
    _HOST_GROUP = (dist.new_group(backend="gloo", timeout=TIMEOUT)
                   if backend == "nccl" else None)
    print(f"process {rank} of {world} ({backend}) on {device}", flush=True)
    return device


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank gating of file writes and logs."""
    return process_index() == 0


def local_devices(device="cuda") -> list:
    """The devices one process may spread a batch over: every visible GPU
    for a bare ``cuda``, else ``device`` alone."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def auto_data_parallel(batch_size: int, enabled: bool = True,
                       what: str = "inference", batch_label: str = "batch",
                       device="cuda"):
    """(devices, scaled batch) for the in-process data parallelism of the
    infer, serve and eval CLIs: one device, or ``enabled=False``
    (``--no_data_parallel``), gives (None, batch_size); several GPUs give
    the list and the batch raised to at least 8 rows a device.  The 8 is
    the JAX package's TPU sublane choice, kept until a measurement on the
    H100 says otherwise.  ``batch_label`` names the scaled value in the
    log (serving passes "default max_batch": an explicit --max_batch
    overrides it)."""
    devices = local_devices(device)
    if not enabled or len(devices) <= 1:
        return None, batch_size
    scaled = max(batch_size, 8 * len(devices))
    print(f"data-parallel {what} over {len(devices)} devices "
          f"({batch_label} {scaled})")
    return devices, scaled


def agree(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (a max all-reduce
    on the host); the flag itself in one process."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def barrier() -> None:
    """Wait for every rank (on the host); nothing in one process."""
    if process_count() > 1:
        dist.barrier(group=_HOST_GROUP)


def gather_to_host(x) -> np.ndarray:
    """The global value of a per-rank array (numpy or tensor, the same
    shape on every rank) as numpy, concatenated along the first axis in
    rank order, on every rank; ``np.asarray`` without a process group.
    NCCL gathers on the device (it cannot gather host tensors); gloo
    gathers on the host (it has no CUDA all-gather)."""
    if not dist.is_initialized():
        return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x))
    t = (x.detach() if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(x)))
    is_bool = t.dtype == torch.bool
    if is_bool:
        t = t.to(torch.uint8)
    world = process_count()
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device())
                 ).contiguous()
        out = t.new_empty((world * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t)
    else:
        t = t.cpu().contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        out = torch.cat(parts)
    out = out.cpu()
    return out.bool().numpy() if is_bool else out.numpy()


def broadcast_from_main(*modules: Optional[torch.nn.Module]) -> None:
    """Give every rank rank 0's parameters and buffers (a guard: the ranks
    build them from the same files and seed)."""
    if process_count() == 1:
        return
    for module in modules:
        if module is None:
            continue
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src=0)


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` over the ranks in place: one all-reduce of a
    flat bucket per dtype.  A no-op without a process group."""
    if not dist.is_initialized() or not tensors:
        return
    world = process_count()
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        if world > 1:
            flat.div_(world)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def mean_over_processes(metrics: dict) -> dict:
    """The 0-d tensors of ``metrics`` averaged over the ranks (per-sample
    means over equal local batches: the global batch's means); other
    entries pass through.  Unchanged without a process group."""
    if not dist.is_initialized():
        return metrics
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0]
    if not keys:
        return metrics
    stacked = torch.stack([metrics[k].float() for k in keys])
    all_reduce_mean_([stacked])
    return {**metrics, **{k: stacked[i].to(metrics[k].dtype)
                          for i, k in enumerate(keys)}}


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, with a gradient (the backward sums the
    ranks' gradients); ``t`` itself in one process."""
    if process_count() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def global_mean(per_sample: torch.Tensor) -> torch.Tensor:
    """Mean of a per-sample vector over the global batch (equal local
    batches), with a gradient; ``per_sample.mean()`` in one process."""
    if process_count() == 1:
        return per_sample.mean()
    total = global_sum(per_sample.sum())
    return total / (per_sample.numel() * process_count())


def draw_global(draw: Callable, local_shape, parts: int = 1):
    """This rank's rows of ``draw(global_shape)``: the noise one process
    would draw for the global batch, so a data-parallel step consumes the
    generator exactly as one process does.  The local batch stacks
    ``parts`` equal blocks (the anchor/positive/negative stack: 3); the
    global batch stacks the same blocks of every rank, and a rank's rows
    are its slice of each block.  ``draw(local_shape)`` in one process."""
    world = process_count()
    if world == 1:
        return draw(tuple(local_shape))
    n = local_shape[0]
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} blocks")
    m, r = n // parts, process_index()
    full = draw((n * world, *local_shape[1:]))
    return torch.cat([full[(j * world + r) * m:(j * world + r + 1) * m]
                      for j in range(parts)])
