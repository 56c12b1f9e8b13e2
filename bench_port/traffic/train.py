"""A ``train_full`` job: ``FullSteps.train_step`` with the trainer's
defaults (the simplified loss: triplet + BCE, AdamW with a clip at 1.0, a
cosine schedule after a linear warm-up), as ``python -m
vae_tagger_tpu_torch.train.train_full`` builds it.

Each step takes ``triplets`` (anchor, positive, negative) triplets of
``resolution`` squared uint8 pixels with their labels: ``host_batches``
distinct seeded host batches, in turn, placed on the device anew by every
step (the step's own ``batch_to_device``).  Set-up builds the one train
state, and drives it through its first ``setup_steps`` steps (which also
warm the step's shapes) on batches whose rows all differ; the same state
then runs the window, whose first step is the next one.
``train_images_per_s`` is the images through the encoder (3 x triplets a
step) of every step launched in the window, over the time until the
device has finished them.

The check: the plain reference (reference/train.py) follows the set-up's
steps and the window's first step from the same weights, batches and
generator seeds, in fp32 with TF32 off.  Per leaf (parameter tensor), a
gap is |program - reference| / max(reference leaf, median reference
leaf), over the leaves whose first reference gradient is at least a
thousandth of the median leaf's (the others, such as the bias of a conv
that a BatchNorm follows, or a key's bias under softmax, are nought but
for round-off and move by it alone).
The numbers, each compared where the cell's file gives it a limit:

- ``loss_rel_gap``: each followed step's loss, the window's first among
  them, |program - reference| / |reference|, the widest;
- ``step1_logit_rel_rms``: the head's training-mode logits of the first
  step (kept as the step made them, the same dropout masks on both
  sides), ‖program - reference‖ / ‖reference‖;
- ``grad1_median_leaf_gap`` and ``grad1_leaf_gap``: the median and the
  widest leaf gap of the first gradient's norm as the optimizer got it
  (read back from AdamW's first moment after one step, m / (1 - beta1));
- ``change_median_leaf_gap`` and ``change_leaf_gap``: the same for the
  norm of each leaf's change over the set-up's steps (the state the window
  starts from).

The head's logits of the first step are kept by a forward hook on the
head, removed once that step has run.  Every later step of the window is
held to a finite loss.  Every leaf of the encoder and the head is
compared; the VAE's decoder gets no gradient under this loss and is left
out.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from bench_port import inputs, program, spec, weights
from bench_port.reference import model as reference
from bench_port.reference.train import TrainReference

NEEDS_TRAIN_REFERENCE = True  # spec.load refuses a family it cannot follow


def host_batches(seed, count, triplets, res, num_tags):
    """``count`` host batches of ``triplets`` triplets, every image
    distinct; each positive shares half of its anchor's tags."""
    n = count * triplets
    images = inputs.image_bank(seed, 3 * n, res, res)
    labels = inputs.label_bank(seed, n, num_tags)
    positive = inputs.label_bank(seed, n, num_tags, stream=inputs.LABELS + 8)
    for a, p in zip(labels, positive):
        keep = np.flatnonzero(a)[: len(np.flatnonzero(a)) // 2]
        p[keep] = 1.0
    out = []
    for i in range(count):
        rows = slice(i * triplets, (i + 1) * triplets)
        out.append({"anchor": images[0 * n:1 * n][rows],
                    "positive": images[1 * n:2 * n][rows],
                    "negative": images[2 * n:3 * n][rows],
                    "labels": labels[rows], "positive_labels": positive[rows]})
    return out


class Setup:
    """The one train state and what set-up read from its first steps."""

    def __init__(self, ctx, fault=None):
        from vae_tagger_tpu_torch.losses.combined import LossConfig
        from vae_tagger_tpu_torch.train.schedule import build_lr_schedule
        from vae_tagger_tpu_torch.train.state import TrainState, build_optimizer
        from vae_tagger_tpu_torch.train.steps import FullSteps

        p, cfg, hp = ctx.params, ctx.config, ctx.params["train"]
        if ctx.device != "cpu":
            built = program.build_kernels()
            if built:
                ctx.log(f"kernels built: {built}")
        ctx.mark("kernels")
        program.apply_precision(cfg)
        dtype = program.DTYPES[cfg["precision"]["compute"]]
        self.w = weights.make(reference.shapes(cfg, with_decoder=True),
                              ctx.seed, ctx.device,
                              family=spec.family(cfg))
        vae, head = program.models(cfg, self.w, ctx.device, True, dtype)
        vae.train()
        head.train()
        self.names = {**{id(q): f"vae.{k}" for k, q in vae.named_parameters()},
                      **{id(q): f"head.{k}"
                         for k, q in head.named_parameters()}}
        schedule = build_lr_schedule("cosine", hp["learning_rate"],
                                     hp["lr_warmup_steps"], hp["total_steps"])
        optimizer = build_optimizer([*vae.parameters(), *head.parameters()],
                                    schedule, hp["weight_decay"],
                                    hp["max_grad_norm"], 1)
        self.state = TrainState(vae=vae, decoder=head, optimizer=optimizer)
        loss_cfg = LossConfig(classification_weight=hp["bce_weight"],
                              triplet_weight=hp["triplet_weight"],
                              use_focal_loss=False,
                              triplet_margin=hp["triplet_margin"],
                              similarity_type="cosine")
        self.steps = FullSteps(loss_cfg, use_simplified=True,
                               compute_dtype=dtype, checkpoint_encode=False,
                               seed=ctx.seed)
        ctx.mark("weights and train state")
        self.batches = host_batches(ctx.seed, p["host_batches"],
                                    p["triplets"], p["resolution"],
                                    cfg["num_tags"])
        ctx.mark("host batches")
        self.fault = fault
        self.losses, self.grad1, self.change = [], None, None
        hook = head.register_forward_hook(self._keep_logits)
        for i in range(p["setup_steps"]):
            m = self.step(i)
            self.losses.append(float(m["loss"]))
            if i == 0:
                self.grad1 = self._first_gradient()
                hook.remove()
        self.logits = self.logits.float()
        self.change = self._change()
        self.index = p["setup_steps"]  # the window's first step

    def step(self, i):
        batch = self.batches[i % len(self.batches)]
        if self.fault == "half":  # half of the batch left out
            half = len(batch["labels"]) // 2
            batch = {k: v[:half] for k, v in batch.items()}
        if self.fault == "unchanged":  # a step that leaves the state as it was
            saved = {k: t.detach().clone()
                     for k, t in self.state.vae.state_dict().items()}
            saved_h = {k: t.detach().clone()
                       for k, t in self.state.decoder.state_dict().items()}
        m = self.steps.train_step(self.state, batch, i)
        if self.fault == "unchanged":
            self.state.vae.load_state_dict(saved)
            self.state.decoder.load_state_dict(saved_h)
        return m

    def _keep_logits(self, module, args, out):
        self.logits = out.detach()

    def _params(self):
        for mod in (self.state.vae, self.state.decoder):
            for q in mod.parameters():
                yield self.names[id(q)], q

    @torch.no_grad()
    def _first_gradient(self):
        adam = self.state.optimizer.adamw
        return {k: float(adam.state[q]["exp_avg"].norm()) / 0.1
                for k, q in self._params() if q in adam.state}

    @torch.no_grad()
    def _change(self):
        return {k: float((q.float() - self.w[k]).norm())
                for k, q in self._params()}


def _leaf_gaps(prog: dict, ref: dict, keep=None):
    """{leaf: |program - reference| / max(reference, median reference)} over
    the reference's leaves (or ``keep``); a leaf the program lacks reads
    1."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}


def _widest(name, gaps, prog, ref, log):
    """The widest gap; the three widest leaves go to the log."""
    top = sorted(gaps, key=gaps.get, reverse=True)[:3]
    log(f"{name}: " + "; ".join(
        f"{k} {gaps[k]:.4g} (program {prog.get(k, 0.0):.6g}, reference "
        f"{ref[k]:.6g})" for k in top))
    return gaps[top[0]] if top else 0.0


def _logit_gap(prog, ref) -> float:
    """‖program - reference‖ / ‖reference‖ of the first step's head
    logits; 1 where rows are missing."""
    if prog.shape != ref.shape:
        return 1.0
    return float((prog.float() - ref.float()).norm() / ref.float().norm())


def compare(s: Setup, ctx, precision="float32") -> dict:
    """The numbers of the check, with the reference in ``precision``
    following ``s``'s steps: the set-up's and the window's first."""
    losses, grad1, logits, change = follow(ctx, s, precision)
    med = statistics.median(grad1.values())
    moved = {k for k, v in grad1.items() if v >= 1e-3 * med}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(s.losses, losses))
    ctx.log(f"losses program {s.losses} reference {losses}; "
            f"{len(grad1)} leaves, {len(moved)} moved by the reference")
    g1 = _leaf_gaps(s.grad1, grad1, moved)
    ch = _leaf_gaps(s.change, change, moved)
    return {"loss_rel_gap": loss_gap,
            "step1_logit_rel_rms": _logit_gap(s.logits, logits),
            "grad1_leaf_gap": _widest("first gradient", g1, s.grad1, grad1,
                                      ctx.log),
            "grad1_median_leaf_gap": statistics.median(g1.values()),
            "change_leaf_gap": _widest("change", ch, s.change, change,
                                       ctx.log),
            "change_median_leaf_gap": statistics.median(ch.values())}


def follow(ctx, s: Setup, precision="float32"):
    """(losses, first gradient's norms, first step's head logits, change
    over the set-up's steps) of the reference in ``precision``, over the
    set-up's steps and the window's first."""
    ref = TrainReference(ctx.config, s.w, ctx.params["train"], ctx.seed,
                         ctx.device, precision)
    losses = []
    for i in range(s.index + 1):
        r = ref.step(s.batches[i % len(s.batches)], i)
        losses.append(r["loss"])
        if i == 0:
            grad1, logits = r["grad_norms"], r["logits"]
        if i == s.index - 1:
            change = ref.change_norms(s.w)
    return losses, grad1, logits, change


def _window(s: Setup, seconds, tracer):
    """(elapsed s, steps, losses of the window's steps)."""
    losses = []
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        with tracer.span("train_step"):
            m = s.step(s.index + n)
        losses.append(m["loss"])
        n += 1
    with tracer.span("synchronize"):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return time.perf_counter() - t0, n, losses


def run(ctx) -> dict:
    from bench_port import arith

    p, cfg = ctx.params, ctx.config
    s = Setup(ctx)
    ctx.setup_done()
    if ctx.trace:
        with ctx.tracer.window():
            elapsed, n, losses = _window(s, ctx.window_seconds, ctx.tracer)
    else:
        elapsed, n, losses = _window(s, ctx.window_seconds, ctx.tracer)
    res, images = p["resolution"], 3 * p["triplets"] * n
    ctx.tracer.counters.update(
        steps=n, images=images, dtype=cfg["precision"]["compute"],
        flops=n * arith.train_full_step_flops(cfg, res, res, p["triplets"]))
    bad = sum(1 for x in losses if not np.isfinite(float(x)))
    ctx.log(f"window {elapsed:.3f} s: {n} steps, {images} images")
    ctx.read_peak()
    s.losses.append(float(losses[0]))  # the window's first step
    s.state = s.steps = None
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = compare(s, ctx)
    ctx.log(f"check: the reference followed {len(s.losses)} steps in "
            f"{time.perf_counter() - t:.3f} s; {numbers}")
    return {"end_to_end": {"train_images_per_s": images / elapsed},
            "attempted": n, "failed": bad,
            "checks": {k: {"value": v, "limit": ctx.limits[k]}
                       for k, v in numbers.items() if k in ctx.limits}}


def readings(ctx, control: str | None = None) -> dict:
    """The check's numbers for one seed, without a window.  ``control``:
    None (the program), a reference precision (``"float8"``,
    ``"bfloat16"``), or a fault planted in the program (``"fault:half"``,
    ``"fault:unchanged"``)."""
    fault = control[6:] if control and control.startswith("fault:") else None
    s = Setup(ctx, fault)
    s.losses.append(float(s.step(s.index)["loss"]))  # as the window's first
    s.state = s.steps = None
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    if control and not fault:
        s.losses, s.grad1, s.logits, s.change = follow(ctx, s, control)
    return compare(s, ctx)
