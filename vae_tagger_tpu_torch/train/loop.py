"""Dataset and loaders, and the epoch loop of the trainer (the port's
counterpart of ``vae_tagger_tpu/train/loop.py``).

- 90/10 train/val split, one dataset shared by both loaders;
- epochs with ``set_epoch`` on the dataset (triplet mining) and the
  loaders (shuffle), so a run is a pure function of its seed;
- metrics read one step late, so the host never waits on the step it just
  queued;
- paired validation: the mining epoch is pinned and the posterior draws of
  batch i, draw d use eval stream i * val_draws + d in every epoch, so the
  epoch-to-epoch comparison behind best-checkpoint selection cancels the
  draw noise; ``--val_draws K`` averages K draws;
- history JSON (``train_loss``, ``val_loss``, ``learning_rates``,
  ``train_metrics`` per loss term), best and periodic callbacks;
- resume: the step count of a restored state continues the epoch numbering
  and skips the batches of a half-done epoch;
- background checkpoints: at an epoch's checkpoint the state is copied to
  the host once, on the main thread (:class:`HostSnapshot`: AdamW updates
  parameters and moments in place, so the writer must not see the live
  tensors), and every callback of that epoch then writes from that copy on
  one worker thread while the next epoch trains; ``--sync_checkpoints``
  runs the callbacks on the live state instead.  The writer is waited on
  before an interrupt save and at the end of the run;
- preemption: :meth:`EpochLoop.run` installs a SIGTERM handler that only
  sets a flag (restored afterwards).  The loop notices it after the step in
  flight, during validation or after the checkpoint callbacks, writes the
  full train state to ``<output_dir>/interrupt_checkpoint`` synchronously
  and returns with ``interrupted`` set (the trainers then skip their final
  phase); ``--resume_from`` continues from it.
  ``VAE_TAGGER_PREEMPT_AFTER_STEPS=N`` acts as if the signal came after N
  train steps of the run (a drill);
- ``--profile_steps N``: a torch.profiler capture (CPU and CUDA) of train
  steps first+2 to first+2+N, written as a chrome trace to
  ``<output_dir>/profile/trace.json``, also when the run ends first; it
  shows the program's spans (utils/profiling.py): ``loop.data``, the wait
  on the train loader for the next batch, each ``steps.train_step`` with
  its phases, and an ``op.*`` range on every ``ops/`` call;
- data parallelism (one process per GPU under torchrun,
  parallel/mesh.py): the global batch is ``--train_batch_size`` times the
  number of processes, each loading its slice; the epoch means weight by
  the global batch's real rows; rank 0 alone logs, profiles and writes
  (checkpoints, exports, history).  torchrun passes SIGTERM to every rank,
  each at its own moment, so the stop flag is agreed (a max all-reduce on
  the host) at every point the loop reads it: all ranks stop after the
  same step, rank 0 saves, and the others wait for the save.
"""

from __future__ import annotations

import copy
import json
import os
import signal
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ..data.dataset import TaggedImageDataset
from ..data.loader import DataLoader, train_val_split
from ..io.checkpoints import save_train_state
from ..parallel import mesh
from ..parallel.mesh import (
    agree,
    barrier,
    is_main_process,
    process_count,
    process_index,
)
from ..parallel.spatial import spatial_parallel_enabled
from ..utils import profiling
from ..utils.pipelining import OneInFlight

# the mining epoch pinned during validation (outside the training range)
_VAL_MINING_EPOCH = -1


def build_dataset_and_loaders(args, return_triplets: bool = True):
    """Dataset + train/val loaders from the trainer's args: aspect-ratio
    buckets with ``--use_bucketing`` (and its three size flags), the YUV
    wire format with ``--transfer_format yuv420``; under data parallelism
    a global batch of ``train_batch_size`` a process, of which each
    process loads its slice.  Under spatial parallelism (one process) the
    global batch is ``train_batch_size``, not multiplied by the devices,
    and the YUV wire format is refused, as in the JAX package."""
    transfer_format = getattr(args, "transfer_format", "rgb") or "rgb"
    if transfer_format != "rgb" and spatial_parallel_enabled(
            args, mesh.local_devices(getattr(args, "device", "cuda"))):
        raise ValueError("--transfer_format yuv420 is not supported with "
                         "--spatial_parallel")
    dataset = TaggedImageDataset(
        json_path=args.json_path, tags_csv_path=args.tags_csv_path,
        resolution=args.resolution, seed=args.seed,
        return_triplets=return_triplets,
        use_bucketing=getattr(args, "use_bucketing", False),
        base_resolution=getattr(args, "base_resolution", 512),
        max_resolution=getattr(args, "max_resolution", 1024),
        bucket_step=getattr(args, "bucket_step", 64),
        transfer_format=transfer_format)
    train_idx, val_idx = train_val_split(len(dataset), 0.1,
                                         seed=args.seed or 42)
    world = process_count()
    global_batch = args.train_batch_size * world
    proc = dict(process_index=process_index(), process_count=world)
    train_loader = DataLoader(dataset, global_batch, shuffle=True,
                              num_workers=args.num_workers,
                              prefetch_factor=args.prefetch_factor,
                              seed=args.seed, indices=train_idx, **proc)
    val_loader = DataLoader(dataset, global_batch, shuffle=False,
                            num_workers=max(1, args.num_workers // 2),
                            prefetch_factor=args.prefetch_factor,
                            seed=args.seed, indices=val_idx, **proc)
    print(f"train size: {len(train_idx)}, val size: {len(val_idx)}, "
          f"batch: {global_batch}"
          + (f" (global, {world} processes)" if world > 1 else ""))
    return dataset, train_loader, val_loader


def _real_rows(batch) -> int:
    """Rows of the global batch that are not the sampler's repeats."""
    if "global_real_count" in batch:
        return int(batch["global_real_count"])
    mask = batch.get("batch_mask")
    return len(batch["labels"]) if mask is None else int(mask.sum())


def _weighted_mean(pairs) -> float:
    weights = [w for _, w in pairs]
    if not pairs or not sum(weights):
        return 0.0
    return float(np.average([v for v, _ in pairs], weights=weights))


def _host_copy(obj):
    """A copy of a state dict with every tensor copied to the host (a
    device tensor's copy waits for the work queued before it)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _host_copy(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return copy.deepcopy(obj)


class _StateDict:
    """A host state dict in a module's place (``state_dict()``)."""

    def __init__(self, state: dict):
        self._state = state

    def state_dict(self) -> dict:
        return self._state


class HostSnapshot:
    """A host copy of a ``TrainState`` at one step, made on the main thread,
    for the checkpoint writer: it answers what the callbacks read, the
    ``step``, ``state_dict()`` (save_train_state) and ``vae``/``decoder``/
    ``adaptive`` with their ``state_dict()`` (the exports)."""

    def __init__(self, state):
        self._state = _host_copy(state.state_dict())
        self.step = self._state["step"]
        for key in ("vae", "decoder", "adaptive"):
            setattr(self, key, _StateDict(self._state[key])
                    if key in self._state else None)

    def state_dict(self) -> dict:
        return self._state


class CheckpointWriter:
    """At most one background checkpoint write in flight: writes run in
    order on one worker thread; a failed write raises on the next
    :meth:`submit` or :meth:`wait`."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt-writer")
        self._pending = None

    def submit(self, fn, *fn_args):
        self.wait()
        self._pending = self._pool.submit(fn, *fn_args)

    def wait(self):
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()


class EpochLoop:
    """Runs epochs; keeps the history; calls the checkpoint callbacks."""

    def __init__(self, args, train_loader, val_loader,
                 run_train_step: Callable, run_eval_step: Callable,
                 on_best: Callable, on_periodic: Optional[Callable] = None,
                 log_metric_keys=("loss",)):
        self.args = args
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.run_train_step = run_train_step
        self.run_eval_step = run_eval_step
        self.on_best = on_best
        self.on_periodic = on_periodic
        self.log_metric_keys = log_metric_keys
        # the schedule advances once per update, every k micro-steps
        self.grad_accum = max(1, getattr(args, "gradient_accumulation_steps",
                                         1) or 1)
        self.history = {"train_loss": [], "val_loss": [],
                        "learning_rates": [], "train_metrics": {}}
        self.best_val_loss = float("inf")
        self._main = is_main_process()
        self._ckpt_writer = (None if getattr(args, "sync_checkpoints", False)
                             or not self._main else CheckpointWriter())
        self.interrupted = False
        self._preempt = False
        self._preempt_after = int(
            os.environ.get("VAE_TAGGER_PREEMPT_AFTER_STEPS", "0") or 0)
        self._profiler = None

    def run(self, state, lr_schedule=None):
        """Train ``args.num_epochs`` epochs; returns the state, early (with
        ``interrupted`` set) after an interrupt save."""
        def on_sigterm(signum, frame):
            self._preempt = True
            print("SIGTERM received: checkpointing and exiting after the "
                  "current step", flush=True)

        try:
            previous = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread: no handler
            return self._run(state, lr_schedule)
        try:
            return self._run(state, lr_schedule)
        finally:
            signal.signal(signal.SIGTERM, previous)

    def _stop(self, drill: bool = False) -> bool:
        """Whether to save and stop here: SIGTERM seen (or the drill's
        step reached) on any rank."""
        return agree(self._preempt or drill)

    def _profile_start(self):
        self._profiler = torch.profiler.profile(
            activities=profiling.activities())
        self._profiler.start()

    def _profile_stop(self, note: str = ""):
        """End the capture after the work queued so far and write its
        chrome trace."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._profiler = self._profiler, None
        prof.stop()
        out = os.path.join(self.args.output_dir, "profile")
        profiling.write_trace(prof, out)
        print(f"profiler trace written to {out}{note}", flush=True)

    def _run(self, state, lr_schedule=None):
        args = self.args
        n_batches = max(1, len(self.train_loader))
        global_step = first_step = state.step
        profile_steps = (getattr(args, "profile_steps", 0) or 0
                         if self._main else 0)
        profile_range = ((first_step + 2, first_step + 2 + profile_steps)
                         if profile_steps else None)
        # a resumed run continues the epoch numbering (fresh triplets and
        # shuffles) and replays a half-done epoch from where it stopped
        epoch_offset = first_step // n_batches
        resume_skip = first_step % n_batches
        dataset = self.train_loader.dataset
        for epoch in range(args.num_epochs):
            mining_epoch = epoch + epoch_offset
            dataset.set_epoch(mining_epoch)
            self.train_loader.set_epoch(mining_epoch)
            self.val_loader.set_epoch(mining_epoch)
            if epoch == 0 and resume_skip:
                if self._main:
                    print(f"mid-epoch resume: skipping {resume_skip} "
                          f"already-trained batches of epoch {epoch_offset}")
                self.train_loader.skip_next(resume_skip)
            epoch_t0 = time.perf_counter()
            metric_acc = {}   # key -> [(value, weight)]
            images_seen = 0

            def drain(step, step_global, metrics, n_real):
                # scalars only: the adaptive weights are a vector
                host = {k: float(v) for k, v in metrics.items()
                        if v.dim() == 0}
                for k, v in host.items():
                    metric_acc.setdefault(k, []).append((v, n_real))
                if self._main and step % args.logging_steps == 0:
                    parts = [f"Epoch: {epoch}", f"Step: {step}"]
                    parts += [f"{k}: {host[k]:.4f}"
                              for k in self.log_metric_keys if k in host]
                    if lr_schedule is not None:
                        lr = lr_schedule(step_global // self.grad_accum)
                        parts.append(f"LR: {lr:.2e}")
                    print(", ".join(parts), flush=True)

            train_pipeline = OneInFlight(drain)
            for step, batch in enumerate(
                    profiling.spanned(self.train_loader, "loop.data")):
                if profile_range and global_step == profile_range[0]:
                    self._profile_start()
                n_real = _real_rows(batch)
                metrics = self.run_train_step(state, batch, global_step)
                if self._profiler is not None \
                        and global_step >= profile_range[1]:
                    self._profile_stop()
                    profile_range = None
                train_pipeline.submit(step, global_step, metrics, n_real)
                images_seen += n_real
                global_step += 1
                if self._stop(self._preempt_after and global_step
                              - first_step >= self._preempt_after):
                    train_pipeline.flush()
                    if self._profiler is not None:
                        self._profile_stop()
                    return self._interrupt_save(state)
            train_pipeline.flush()
            if self._stop():  # arrived between the last step and validation
                return self._interrupt_save(state)

            val_pairs = []
            val_pipeline = OneInFlight(
                lambda loss, n: val_pairs.append((float(loss), n)))
            dataset.set_epoch(_VAL_MINING_EPOCH)
            val_draws = max(1, int(getattr(args, "val_draws", 1) or 1))
            stop = False
            for i, batch in enumerate(self.val_loader):
                for d in range(val_draws):
                    stop = self._stop()
                    if stop:  # save now: a slow validation could outlast
                        break  # the grace window
                    metrics = self.run_eval_step(state, batch,
                                                 i * val_draws + d)
                    val_pipeline.submit(metrics["loss"], _real_rows(batch))
                if stop:
                    break
            val_pipeline.flush()
            dataset.set_epoch(mining_epoch)
            if stop or self._stop():
                return self._interrupt_save(state)

            avg_train = _weighted_mean(metric_acc.get("loss", []))
            avg_val = _weighted_mean(val_pairs)
            lr = (lr_schedule(global_step // self.grad_accum)
                  if lr_schedule else 0.0)
            self.history["train_loss"].append(avg_train)
            for k, pairs in metric_acc.items():
                self.history["train_metrics"].setdefault(k, []).append(
                    _weighted_mean(pairs))
            self.history["val_loss"].append(avg_val)
            self.history["learning_rates"].append(lr)
            dt = time.perf_counter() - epoch_t0
            if self._main:
                print(f"Epoch {epoch} completed - Train Loss: "
                      f"{avg_train:.4f}, Val Loss: {avg_val:.4f} "
                      f"({images_seen / max(dt, 1e-9):.2f} images/sec)",
                      flush=True)
            callbacks = []
            if avg_val < self.best_val_loss:
                self.best_val_loss = avg_val
                if self._main:
                    print(f"New best validation loss: {avg_val:.4f}")
                callbacks.append(self.on_best)
            if (self.on_periodic is not None
                    and (epoch + 1) % args.save_steps == 0):
                callbacks.append(self.on_periodic)
            if callbacks and self._main:
                self._checkpoint(callbacks, state, epoch)
            if self._stop():  # during the checkpoint: save now, not an
                return self._interrupt_save(state)  # epoch later
        if self._profiler is not None:
            self._profile_stop(" (run shorter than --profile_steps)")
        if self._ckpt_writer is not None:  # callers read the files next
            self._ckpt_writer.wait()
        return state

    def _checkpoint(self, callbacks, state, epoch):
        """Run this epoch's checkpoint callbacks: on the live state with
        ``--sync_checkpoints``, else on one host snapshot, taken here, from
        the writer thread."""
        if self._ckpt_writer is None:
            for callback in callbacks:
                callback(state, epoch)
            return
        snapshot = HostSnapshot(state)

        def write_all():
            for callback in callbacks:
                callback(snapshot, epoch)

        self._ckpt_writer.submit(write_all)

    def _interrupt_save(self, state):
        """The synchronous full-state save of a preemption (rank 0; the
        other ranks wait for it); sets ``interrupted`` so the trainers
        skip their final phase."""
        self.interrupted = True
        if self._main:
            if self._ckpt_writer is not None:
                self._ckpt_writer.wait()  # no race with an epoch's write
            path = os.path.join(self.args.output_dir, "interrupt_checkpoint")
            save_train_state(state, path)
            print(f"interrupt checkpoint saved at step {state.step}: "
                  f"{path}\nresume with --resume_from {path}", flush=True)
        barrier()
        return state

    def save_history(self, output_dir: str):
        if not self._main:
            return
        with open(os.path.join(output_dir, "training_history.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.history, f, indent=2)
