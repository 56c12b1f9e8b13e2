"""Offline encode+tag, as ``python -m vae_tagger_tpu_torch.infer`` runs it.

A bank of ``bank_images`` seeded RGB uint8 images of ``resolution``
squared, decoded in host memory, is cut into batches of ``batch`` and fed
in order, round and round, through ``TaggerEngine.classify_async`` with
one batch in flight (the CLI's pipeline): each call queues a batch, then
the previous batch's probabilities are read back to the host.  Set-up
warms the one batch shape twice.  The window launches batches until
``--seconds`` have passed, then reads back the last; ``infer_images_per_s``
is every image launched in it over the time to its last read-back.

The check: ``check_images`` of the bank, drawn from the seed; every answer
the window gave for one of them is held against the plain reference's
fp32 probabilities of the same pixels (widest gap, ``prob_max_abs``; a
run that compared no answer reads infinity).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_port import inputs, program, spec, weights
from bench_port.reference import model as reference


def _window(engine, batches, seconds, tracer, max_batches=None):
    """(elapsed s, [(batch index, host probs)], [enqueue s]): batches
    launched until ``seconds`` have passed (or ``max_batches`` are)."""
    done, enqueue = [], []
    pending = None
    i = 0
    t0 = time.perf_counter()
    while True:
        more = (time.perf_counter() - t0 < seconds if max_batches is None
                else i < max_batches)
        if more or pending is None:
            k = i % len(batches)
            with tracer.span("classify_async"):
                ta = time.perf_counter()
                probs, _ = engine.classify_async(batches[k])
                enqueue.append(time.perf_counter() - ta)
            i += 1
        else:
            k, probs = None, None
        if pending is not None:
            with tracer.span("wait_result"):
                done.append((pending[0], pending[1].cpu().numpy()))
        if probs is None:
            break
        pending = (k, probs)
    return time.perf_counter() - t0, done, enqueue


def reference_probs(config, w, bank, indices, device, precision="float32",
                    block=4):
    """{bank index: probabilities} of the plain reference."""
    ref = reference.EncodeTag(config, w, device, precision)
    out = {}
    for s in range(0, len(indices), block):
        idx = indices[s:s + block]
        px = torch.from_numpy(bank[idx]).to(device)
        probs = torch.sigmoid(ref.logits(px)).cpu().numpy()
        out.update(zip(idx, probs))
    del ref
    return out


def compare(done, batches_index, ref_probs):
    """Widest gap between an answer of the window and the reference, over
    every answer for an image the reference computed; (gap, answers
    compared, images with a non-finite or missing answer)."""
    gap, n, bad = 0.0, 0, 0
    for k, probs in done:
        for row, img in zip(probs, batches_index[k]):
            if not np.isfinite(row).all():
                bad += 1
                continue
            if img in ref_probs:
                gap = max(gap, float(np.abs(row - ref_probs[img]).max()))
                n += 1
    return gap, n, bad


def setup(ctx):
    """(engine, weights, bank, batches, batch image indices)."""
    p, cfg = ctx.params, ctx.config
    if ctx.device != "cpu":
        built = program.build_kernels()
        if built:
            ctx.log(f"kernels built: {built}")
    ctx.mark("kernels")
    program.apply_precision(cfg)
    w = weights.make(reference.shapes(cfg), ctx.seed, ctx.device,
                     family=spec.family(cfg))
    engine = program.tagger_engine(cfg, w, ctx.device)
    ctx.mark("weights and engine")
    res, b = p["resolution"], p["batch"]
    bank = inputs.image_bank(ctx.seed, p["bank_images"], res, res)
    ctx.mark("image bank")
    index = [list(range(s, s + b)) for s in range(0, len(bank), b)]
    batches = [bank[i] for i in index]
    for k in range(2):  # the one shape, twice
        engine.classify_async(batches[k % len(batches)])[0].cpu()
    return engine, w, bank, batches, index


def run(ctx) -> dict:
    from bench_port import arith

    p, cfg = ctx.params, ctx.config
    engine, w, bank, batches, index = setup(ctx)
    ctx.setup_done()
    if ctx.trace:
        with ctx.tracer.window():
            elapsed, done, enqueue = _window(engine, batches,
                                             ctx.window_seconds, ctx.tracer)
    else:
        elapsed, done, enqueue = _window(engine, batches, ctx.window_seconds,
                                         ctx.tracer)
    images = sum(len(probs) for _, probs in done)
    res = p["resolution"]
    ctx.tracer.counters.update(
        images=images, enqueue_s=enqueue,
        flops=images * arith.encode_tag_flops(cfg, res, res),
        dtype=cfg["precision"]["compute"])
    ctx.log(f"window {elapsed:.3f} s: {images} images, "
            f"{len(done)} batches of {p['batch']}")
    ctx.read_peak()
    del engine
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    sample = inputs.sample(ctx.seed, len(bank), p["check_images"])
    ref = reference_probs(cfg, w, bank, sample, ctx.device)
    gap, n, bad = compare(done, index, ref)
    ctx.log(f"check: {n} answers of {len(sample)} images against the "
            f"reference in {time.perf_counter() - t:.3f} s")
    return {"end_to_end": {"infer_images_per_s": images / elapsed},
            "attempted": images, "failed": bad,
            "checks": {"prob_max_abs": {
                "value": gap if n else float("inf"),
                "limit": ctx.limits["prob_max_abs"]}}}


def readings(ctx, control: str | None = None) -> dict:
    """The numbers the check compares, for one seed, without a measured
    window: the program's answers over one pass of the bank through the
    timed path; with ``control`` (a reference precision), the reference in
    that precision in the program's place."""
    p, cfg = ctx.params, ctx.config
    engine, w, bank, batches, index = setup(ctx)
    if control is None:
        _, done, _ = _window(engine, batches, 0.0, ctx.tracer, len(batches))
    del engine
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    sample = inputs.sample(ctx.seed, len(bank), p["check_images"])
    if control is not None:
        low = reference_probs(cfg, w, bank, sample, ctx.device, control)
        done = [(None, np.stack([low[i] for i in sample]))]
        index = {None: sample}
    ref = reference_probs(cfg, w, bank, sample, ctx.device)
    gap, n, bad = compare(done, index, ref)
    return {"prob_max_abs": gap, "answers": n, "non_finite": bad}
