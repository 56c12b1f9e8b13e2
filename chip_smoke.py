#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vae_tagger_tpu_torch) on one GPU.

    python3 chip_smoke.py [--report PATH]

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout;
imports nothing of JAX or of the JAX package.  Phases, each fatal on
failure (non-zero exit, no ``ok`` line):

1. the card's name and power limit (nvidia-smi);
2. build every kernel of ``vae_tagger_tpu_torch/csrc`` (one nvcc per source,
   all at once) and print the build seconds and register use;
3. kernel phases: each kernel against its plain PyTorch version on the card,
   at the encode path's shapes (batch 4 at 1024px), in fp32 (TF32 off) and
   bf16.  fp32: max relative error <= 1e-4.  bf16: error against the plain
   fp32 result within 4x the plain version's own bf16 error (with a floor
   of 1e-4 where the plain version's arithmetic is fp32 whatever the input
   dtype).  Each kernel is timed with CUDA events, beside its plain version
   and one PyTorch library call computing the same function (a yardstick
   only; the port never calls it);
   Kernels D and E (the flash-attention backward) are checked the same way
   at the training step's shapes (B=3, S=16,384 and 4,096, D=512) and timed
   beside the backward of ``F.scaled_dot_product_attention``;
4. autograd on the card: the outputs of A, B and C on tensors that require
   a gradient carry a ``grad_fn``, and each op's gradients through the
   kernel path match the torch backend in fp32 (relative error <= 1e-4);
5. inference path: the full FLUX VAE (block_out_channels (128, 256, 512,
   512), 32 groups, 16 latent channels) and the default attention head on
   seeded random weights, written in diffusers layout and as
   pytorch_model.bin, then ``python -m vae_tagger_tpu_torch.infer``'s entry
   point on seeded 1024px PNGs at batch 4 in bf16.  Checks: every image in
   the JSON, finite probabilities, every kernel launched (A twice, B 20
   times and C once per batch), and fp32 latents of the kernel path within
   MSE 1e-4 of the plain (torch-backend) path on the same batch;
6. training path: the same weights and images as a tagged dataset (2,000
   tags), then ``python -m vae_tagger_tpu_torch.train.train_full``'s entry
   point for one epoch at 1024px, batch 1 (a stacked triplet of 3 images),
   bf16, no warmup.  Checks: finite losses, the exact launch counts (per
   train step A 2, stats 20, B 20, C 1, D 1, E 1; per validation batch the
   forward's), every encoder and head parameter changed, the exported VAE
   (with the checkpoint's decoder tensor kept) and head classify through
   ``TaggerEngine``.  Then the steady step time, images/s and peak memory,
   a profiler breakdown of one step by kernel, and the gradient gate: on
   one fp32 batch, every parameter's gradient through the kernel path
   within 1e-3 of the torch backend's, relative, or absolute where the
   torch path's norm is below 1e-8 (gradients that are zero in exact
   arithmetic);
7. one JSON line ``{"kernels": [...]}``, then as the last line
   ``{"ok": true, "device": {...}}``.

With ``--report PATH`` the full report is also written there as JSON.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

BATCH = 4
RES = 1024
N_IMAGES = 8
GROUPS = 32
SEED = 0
# one train step at batch 1 encodes the stacked anchor/positive/negative
TRAIN_ROWS = 3
NUM_TAGS = 2000

# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# The 20 fused convs of one FLUX encoder forward at 1024px:
# (H=W, Cin, Cout, variant, Cres, launches per forward).
B_CASES = [
    (1024, 128, 128, "plain", None, 2),
    (1024, 128, 128, "residual", 128, 2),
    (512, 128, 256, "plain", None, 1),
    (512, 256, 256, "shortcut", 128, 1),
    (512, 256, 256, "plain", None, 1),
    (512, 256, 256, "residual", 256, 1),
    (256, 256, 512, "plain", None, 1),
    (256, 512, 512, "shortcut", 256, 1),
    (256, 512, 512, "plain", None, 1),
    (256, 512, 512, "residual", 512, 1),
    (128, 512, 512, "plain", None, 4),
    (128, 512, 512, "residual", 512, 4),
]
B_PER_FORWARD = sum(c[-1] for c in B_CASES)

KERNELS = {
    "group_norm_silu": dict(
        route="cuda", source="vae_tagger_tpu_torch/csrc/groupnorm_silu.cu",
        replaces="vae_tagger_tpu/ops/pallas/groupnorm_silu.py:122 and :213"),
    "group_stats": dict(
        route="cuda", source="vae_tagger_tpu_torch/csrc/groupnorm_silu.cu",
        replaces="vae_tagger_tpu/ops/pallas/groupnorm_silu.py:48 (stats "
                 "pass of kernel A, fed to the fused conv)"),
    "gn_silu_conv3x3": dict(
        route="cuda", source="vae_tagger_tpu_torch/csrc/gn_silu_conv3x3.cu",
        replaces="vae_tagger_tpu/ops/pallas/conv_fused.py:173"),
    "flash_attention_fwd": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="vae_tagger_tpu/ops/pallas/flash_attention.py:87"),
    "flash_attention_bwd_dq": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="vae_tagger_tpu/ops/pallas/flash_attention.py:154 "
                 "(_bwd_dq_kernel, pallas_call at :265)"),
    "flash_attention_bwd_dkv": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="vae_tagger_tpu/ops/pallas/flash_attention.py:187 "
                 "(_bwd_dkv_kernel, pallas_call at :296)"),
}
# launches of one train step and of one validation (forward-only) batch
TRAIN_STEP_LAUNCHES = {"group_norm_silu": 2, "group_stats": 20,
                       "gn_silu_conv3x3": 20, "flash_attention_fwd": 1,
                       "flash_attention_bwd_dq": 1,
                       "flash_attention_bwd_dkv": 1}
EVAL_LAUNCHES = dict(TRAIN_STEP_LAUNCHES, flash_attention_bwd_dq=0,
                     flash_attention_bwd_dkv=0)


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

def time_ms(fn, iters=3):
    """Mean device time of fn() over iters calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, ref):
    ref = ref.float()
    return ((a.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def abs_err(a, ref):
    return (a.float() - ref.float()).abs().max().item()


class Check:
    """Kernel vs plain on the same inputs, fp32 and bf16."""

    def __init__(self, name):
        self.name = name
        self.rows = []

    def run(self, label, op):
        """op(dtype) -> tensor or tuple of tensors.  The inputs op closes
        over are bf16-representable, so both dtypes see the same values."""
        import torch
        from vae_tagger_tpu_torch.ops import backend

        def outs(dt, be):
            with backend.backend(be):
                r = op(dt)
            torch.cuda.synchronize()
            return r if isinstance(r, tuple) else (r,)

        p32 = outs(torch.float32, "torch")
        k32 = outs(torch.float32, "kernel")
        p16 = outs(torch.bfloat16, "torch")
        k16 = outs(torch.bfloat16, "kernel")
        for i, ref in enumerate(p32):
            e32 = rel_err(k32[i], ref)
            a32 = abs_err(k32[i], ref)
            ek = rel_err(k16[i], ref)
            ep = rel_err(p16[i], ref)
            tol16 = max(4 * ep, 1e-4)
            ok = (e32 <= 1e-4 and ek <= tol16
                  and all(bool(torch.isfinite(t).all()) for t in
                          (k32[i], k16[i])))
            row = dict(case=f"{label}[{i}]", rel_err_fp32=e32,
                       abs_err_fp32=a32, rel_err_bf16=ek,
                       plain_rel_err_bf16=ep, tol_bf16=tol16, ok=ok)
            self.rows.append(row)
            log(f"  {self.name} {row['case']}: fp32 rel {e32:.3e} "
                f"(abs {a32:.3e}); bf16 rel {ek:.3e} vs plain {ep:.3e} "
                f"(tol {tol16:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{self.name} {label}: kernel disagrees "
                                     f"with its plain version: {row}")

    def summary(self):
        return dict(
            max_abs_err=max(r["abs_err_fp32"] for r in self.rows),
            max_rel_err_fp32=max(r["rel_err_fp32"] for r in self.rows),
            max_rel_err_bf16=max(r["rel_err_bf16"] for r in self.rows),
            plain_rel_err_bf16=max(r["plain_rel_err_bf16"]
                                   for r in self.rows),
            cases=len(self.rows))


def bound(nbytes, flops, dtype="bfloat16"):
    """Least time on an H100 SXM at the published peaks: the larger of bytes
    over HBM bandwidth and operations over the peak rate for the type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s)")
    return smi


def _ptxas_function(line):
    """``name<dtype[, variant]>`` of a ptxas "Compiling entry function"
    line, read from the mangled name's length-prefixed identifier that
    ends in ``_kernel``; None for other lines."""
    m = re.search(r"entry function '(\w+)'", line)
    if not m:
        return None
    mangled = m.group(1)
    found = None  # the last such identifier: the function's own name
    for run in re.finditer(r"\d+", mangled):
        for i in range(run.start(), run.end()):
            n = int(mangled[i:run.end()])
            name = mangled[run.end():run.end() + n]
            if len(name) == n and re.fullmatch(r"[A-Za-z]\w*_kernel", name):
                found = (name, mangled[run.end() + n:])
    if found is None:
        return None
    name, args = found
    t = re.match(r"I(13__nv_bfloat16|f)(L[bi](\d))?", args)
    if not t:
        return name
    dtype = "bf16" if t.group(1) != "f" else "f32"
    return f"{name}<{dtype}{', ' + t.group(3) if t.group(3) else ''}>"


def phase_build():
    from vae_tagger_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    wall = time.perf_counter() - t0
    log(f"build: {wall:.1f} s wall for {len(built)} sources (parallel nvcc)")
    resources = {}
    for stem, rec in built.items():
        log(f"  {stem}: {rec['seconds']:.1f} s")
        # ptxas -v: "Compiling entry function '<mangled>'", then the spill
        # line and the register line of that function
        fn = None
        for ln in rec["log"].splitlines():
            fn = _ptxas_function(ln) or fn
            m = re.search(r"(\d+) bytes spill stores", ln)
            if fn and m:
                resources.setdefault(fn, {})["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", ln)
            if fn and m:
                resources.setdefault(fn, {})["registers"] = int(m.group(1))
                log(f"    {fn}: {m.group(1)} registers, "
                    f"{resources[fn].get('spill_stores', 0)} bytes spill "
                    f"stores")
    for stem in _build.SIGNATURES:
        _build.lib(stem)  # loads, raises if a library is missing
    return {"wall_s": wall,
            "sources": {k: v["seconds"] for k, v in built.items()},
            "kernel_resources": resources}


def _rnd(g, *shape, scale=1.0, shift=0.0):
    """Seeded normal tensor on the card, rounded to bf16-representable
    fp32 values."""
    import torch

    t = torch.randn(*shape, generator=g) * scale + shift
    return t.bfloat16().float().cuda()


def _both(t):
    """{dtype: t in that dtype}, cast once so no timed call pays a cast."""
    import torch

    if t is None:
        return {torch.float32: None, torch.bfloat16: None}
    return {torch.float32: t, torch.bfloat16: t.bfloat16()}


def phase_kernel_a(g, results):
    import torch
    import torch.nn.functional as F
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.normalization import group_norm_silu

    log("kernel A: group_norm_silu at the mid-block and conv_norm_out sites")
    chk = Check("group_norm_silu")
    shape = (BATCH, RES // 8, RES // 8, 512)
    x = _rnd(g, *shape, shift=0.5)
    xs = _both(x)
    xb = xs[torch.bfloat16]
    sc = _rnd(g, 512, scale=0.2, shift=1.0)
    bi = _rnd(g, 512, scale=0.1)
    ms = plain_ms = lib_ms = 0.0
    for silu in (False, True):
        def op(dt, silu=silu):
            return group_norm_silu(xs[dt], sc, bi, num_groups=GROUPS,
                                   apply_silu=silu)

        chk.run(f"{shape} silu={silu}", op)

        def library(silu=silu):
            y = F.group_norm(xb.permute(0, 3, 1, 2), GROUPS, sc.bfloat16(),
                             bi.bfloat16(), 1e-6)
            return F.silu(y) if silu else y

        ms += time_ms(lambda: op(torch.bfloat16))
        with backend.backend("torch"):
            plain_ms += time_ms(lambda: op(torch.bfloat16))
        lib_ms += time_ms(library)
    nbytes = 2 * 2 * x.numel() * 2  # two launches, x read + out written, bf16
    b_ms, b_by = bound(nbytes, 2 * 10 * x.numel())
    results["group_norm_silu"] = dict(
        chk.summary(), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by,
        library="F.group_norm + F.silu (channels_last)",
        per=f"2 launches: one batch of {BATCH} at {RES}px, bf16")


def phase_kernel_b(g, results):
    import torch
    import torch.nn.functional as F
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.conv import gn_silu_conv3x3
    from vae_tagger_tpu_torch.ops.normalization import group_norm_affine

    log(f"kernel B: gn_silu_conv3x3 at the {B_PER_FORWARD} encoder convs; "
        f"kernel A's stats pass (group_stats) on their inputs")
    chk = Check("gn_silu_conv3x3")
    chk_s = Check("group_stats")
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0)
    st = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0)
    for hw, cin, cout, variant, cres, mult in B_CASES:
        x = _rnd(g, BATCH, hw, hw, cin)
        gs = _rnd(g, cin, scale=0.2, shift=1.0)
        gb = _rnd(g, cin, scale=0.1)
        k = _rnd(g, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        b = _rnd(g, cout, scale=0.1)
        res = _rnd(g, BATCH, hw, hw, cres) if cres else None
        sck = _rnd(g, cres, cout, scale=cres ** -0.5) if variant == "shortcut" else None
        scb = _rnd(g, cout, scale=0.1) if variant == "shortcut" else None

        xs, rs = _both(x), _both(res)

        def op(dt):
            return gn_silu_conv3x3(xs[dt], gs, gb, k, b, rs[dt], sck, scb,
                                   num_groups=GROUPS)

        label = f"{hw}^2 {cin}->{cout} {variant}"
        chk.run(label, op)

        def stats_op(dt):
            return group_norm_affine(xs[dt], gs, gb, num_groups=GROUPS)

        chk_s.run(label, stats_op)

        xb, kb, rb = xs[torch.bfloat16], k.bfloat16(), rs[torch.bfloat16]
        w_oihw = kb.permute(3, 2, 0, 1).contiguous()
        sc_oihw = (None if sck is None
                   else sck.bfloat16().t()[:, :, None, None].contiguous())

        def library():
            y = F.silu(F.group_norm(xb.permute(0, 3, 1, 2), GROUPS,
                                    gs.bfloat16(), gb.bfloat16(), 1e-6))
            out = F.conv2d(y, w_oihw, b.bfloat16(), padding=1)
            if sc_oihw is not None:
                out = out + F.conv2d(rb.permute(0, 3, 1, 2), sc_oihw,
                                     scb.bfloat16())
            elif rb is not None:
                out = out + rb.permute(0, 3, 1, 2)
            return out

        def library_stats():
            return torch.var_mean(xb.view(BATCH, hw * hw, GROUPS, -1).float(),
                                  dim=(1, 3), correction=0)

        bf = lambda: op(torch.bfloat16)  # noqa: E731
        sbf = lambda: stats_op(torch.bfloat16)  # noqa: E731
        tot["ms"] += mult * time_ms(bf)
        st["ms"] += mult * time_ms(sbf)
        with backend.backend("torch"):
            tot["plain_ms"] += mult * time_ms(bf)
            st["plain_ms"] += mult * time_ms(sbf)
        tot["library_ms"] += mult * time_ms(library)
        st["library_ms"] += mult * time_ms(library_stats)
        m = BATCH * hw * hw
        k_dim = 9 * cin + (cres if variant == "shortcut" else 0)
        tot["flops"] += mult * 2.0 * m * k_dim * cout
        tot["nbytes"] += mult * 2.0 * (m * cin + m * cout + (m * cres if cres else 0)
                                       + k_dim * cout)
        st["nbytes"] += mult * 2.0 * m * cin
    b_ms, b_by = bound(tot["nbytes"], tot["flops"])
    results["gn_silu_conv3x3"] = dict(
        chk.summary(), ms=tot["ms"], plain_ms=tot["plain_ms"],
        library_ms=tot["library_ms"], bound_ms=b_ms, bound_by=b_by,
        flops=tot["flops"],
        library="F.group_norm + F.silu + cuDNN F.conv2d + residual add or "
                "1x1 F.conv2d (NCHW views of channels_last tensors)",
        per=f"{B_PER_FORWARD} launches: one batch of {BATCH} at {RES}px, bf16")
    s_ms, s_by = bound(st["nbytes"], 0.0)
    results["group_stats"] = dict(
        chk_s.summary(), ms=st["ms"], plain_ms=st["plain_ms"],
        library_ms=st["library_ms"], bound_ms=s_ms, bound_by=s_by,
        library="torch.var_mean over the groups (fp32 upcast)",
        per=f"{B_PER_FORWARD} launches: one batch of {BATCH} at {RES}px, bf16")


def phase_kernel_c(g, results):
    import torch
    import torch.nn.functional as F
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.attention import flash_attention_fwd

    log("kernel C: flash_attention_fwd, one head, D=512")
    chk = Check("flash_attention_fwd")
    d = 512
    timed = {}
    # the mid-block sequence at 512px and at 1024px
    for s in ((RES // 16) ** 2, (RES // 8) ** 2):
        qs, ks, vs = (_both(_rnd(g, BATCH, s, d)) for _ in range(3))

        def op(dt):
            return flash_attention_fwd(qs[dt], ks[dt], vs[dt])

        chk.run(f"B={BATCH} S={s}", op)
        if s == (RES // 8) ** 2:
            qb, kb, vb = (t[torch.bfloat16] for t in (qs, ks, vs))
            bf = lambda: op(torch.bfloat16)  # noqa: E731
            timed["ms"] = time_ms(bf)
            with backend.backend("torch"):
                timed["plain_ms"] = time_ms(bf)
            timed["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qb[:, None], kb[:, None], vb[:, None]))
            flops = 4.0 * BATCH * s * s * d
            nbytes = 2.0 * 4 * BATCH * s * d + 4.0 * BATCH * s
        del qs, ks, vs
        torch.cuda.empty_cache()
    b_ms, b_by = bound(nbytes, flops)
    results["flash_attention_fwd"] = dict(
        chk.summary(), **timed, bound_ms=b_ms, bound_by=b_by, flops=flops,
        library="F.scaled_dot_product_attention",
        per=f"1 launch: one batch of {BATCH} at {RES}px "
            f"(S={(RES // 8) ** 2}), bf16")


def phase_kernel_de(g, results):
    import torch
    import torch.nn.functional as F
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.attention import (
        bwd_delta,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )

    log(f"kernels D and E: flash_attention_bwd_dq and _dkv, one head, D=512, "
        f"B={TRAIN_ROWS} (one train step at batch 1)")
    chk = {"flash_attention_bwd_dq": Check("flash_attention_bwd_dq"),
           "flash_attention_bwd_dkv": Check("flash_attention_bwd_dkv")}
    fns = {"flash_attention_bwd_dq": flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": flash_attention_bwd_dkv}
    d, b = 512, TRAIN_ROWS
    timed = {}
    for s in ((RES // 16) ** 2, (RES // 8) ** 2):
        q, k, v, do = (_rnd(g, b, s, d) for _ in range(4))
        with backend.backend("torch"):
            o, lse = flash_attention_fwd(q, k, v)
        delta = bwd_delta(o, do)
        ins = {dt: tuple(t.to(dt) for t in (q, k, v, do))
               for dt in (torch.float32, torch.bfloat16)}
        for name, fn in fns.items():
            chk[name].run(f"B={b} S={s}",
                          lambda dt, fn=fn: fn(*ins[dt], lse, delta))
        if s == (RES // 8) ** 2:
            for name, fn in fns.items():
                bf = lambda fn=fn: fn(*ins[torch.bfloat16], lse, delta)  # noqa: E731
                timed[name] = {"ms": time_ms(bf)}
                with backend.backend("torch"):
                    timed[name]["plain_ms"] = time_ms(bf)
            with torch.enable_grad():
                qb, kb, vb = (t[:, None].detach().requires_grad_()
                              for t in ins[torch.bfloat16][:3])
                out = F.scaled_dot_product_attention(qb, kb, vb)
                dob = ins[torch.bfloat16][3][:, None]
                lib_ms = time_ms(lambda: torch.autograd.grad(
                    out, (qb, kb, vb), dob, retain_graph=True))
                del out, qb, kb, vb
            n_in = 2.0 * 4 * b * s * d + 4.0 * 2 * b * s  # q k v dO, L Dl
            sizes = {"flash_attention_bwd_dq": (6.0, n_in + 2.0 * b * s * d),
                     "flash_attention_bwd_dkv": (8.0,
                                                 n_in + 4.0 * b * s * d)}
            for name, (mult, nbytes) in sizes.items():
                flops = mult * b * s * s * d
                b_ms, b_by = bound(nbytes, flops)
                timed[name].update(library_ms=lib_ms, bound_ms=b_ms,
                                   bound_by=b_by, flops=flops)
        del q, k, v, do, o, lse, delta, ins
        torch.cuda.empty_cache()
    for name in fns:
        results[name] = dict(
            chk[name].summary(), **timed[name],
            library="backward of F.scaled_dot_product_attention (dq, dk "
                    "and dv in one call)",
            per=f"1 launch: one train step at batch 1, {RES}px "
                f"(B={TRAIN_ROWS} stacked, S={(RES // 8) ** 2}), bf16")


def phase_autograd(g):
    import torch
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.attention import flash_attention
    from vae_tagger_tpu_torch.ops.conv import gn_silu_conv3x3
    from vae_tagger_tpu_torch.ops.normalization import group_norm_silu

    log("autograd on the card: A, B and C carry gradients; kernel path vs "
        "torch backend in fp32 (relative error <= 1e-4)")

    def leaf(*shape, **kw):
        return _rnd(g, *shape, **kw).requires_grad_()

    hw, c = RES // 8, 512  # the mid-block sites at 1024px
    x = leaf(TRAIN_ROWS, hw, hw, c, shift=0.3)
    gs, gb = leaf(c, scale=0.2, shift=1.0), leaf(c, scale=0.1)
    kern, bias = leaf(3, 3, c, c, scale=(9 * c) ** -0.5), leaf(c, scale=0.1)
    q, k, v = (leaf(TRAIN_ROWS, (RES // 16) ** 2, c) for _ in range(3))
    cases = {
        "group_norm_silu": (lambda: group_norm_silu(x, gs, gb,
                                                    num_groups=GROUPS),
                            (x, gs, gb)),
        "gn_silu_conv3x3": (lambda: gn_silu_conv3x3(
            x, gs, gb, kern, bias, x, num_groups=GROUPS),
            (x, gs, gb, kern, bias)),
        "flash_attention": (lambda: flash_attention(q, k, v), (q, k, v)),
    }
    out = {}
    for name, (fn, inputs) in cases.items():
        backend.reset_launch_counts()
        y = fn()
        assert y.grad_fn is not None, f"{name}: the kernel output has no grad_fn"
        gy = _rnd(g, *y.shape)
        got = torch.autograd.grad(y, inputs, gy)
        torch.cuda.synchronize()
        launched = {k: n for k, n in backend.launch_counts().items() if n}
        assert launched, f"{name}: no kernel launched"
        with backend.backend("torch"):
            want = torch.autograd.grad(fn(), inputs, gy)
        errs = [((a - w).norm() / w.norm()).item() for a, w in zip(got, want)]
        log(f"  {name}: grad_fn {type(y.grad_fn).__name__}, launches "
            f"{launched}, gradient rel errors "
            f"{', '.join(f'{e:.2e}' for e in errs)}")
        assert all(e <= 1e-4 for e in errs), (name, errs)
        out[name] = dict(grad_fn=type(y.grad_fn).__name__, launches=launched,
                         rel_errs=errs)
        del y, got, want
    return out


def _write_artifacts(num_tags=2000):
    """Seeded full-width weights in diffusers layout, a head .bin, tags and
    PNGs under build/chip_smoke."""
    import numpy as np
    import torch
    from PIL import Image
    from vae_tagger_tpu_torch.core.config import default_flux_vae_config
    from vae_tagger_tpu_torch.infer.engine import build_decoder
    from vae_tagger_tpu_torch.io.checkpoints import (
        save_decoder_bin,
        save_vae_pretrained,
    )
    from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from vae_tagger_tpu_torch.nn.blocks import seeded_init_

    shutil.rmtree(WORK, ignore_errors=True)
    (WORK / "images").mkdir(parents=True)
    cfg = default_flux_vae_config()
    vae = seeded_init_(AutoencoderKL(cfg), SEED)
    save_vae_pretrained(vae, cfg, str(WORK / "vae"))
    head = build_decoder(num_tags, True, None, cfg.latent_channels, SEED + 1)
    g = torch.Generator().manual_seed(SEED + 2)
    bn = head.feature_compress[1]
    bn.running_mean.copy_(torch.randn(bn.num_features, generator=g) * 0.1)
    bn.running_var.copy_(torch.rand(bn.num_features, generator=g) + 0.5)
    save_decoder_bin(head, str(WORK / "pytorch_model.bin"))
    with open(WORK / "tags.csv", "w", encoding="utf-8") as f:
        f.write("name,count\n")
        f.writelines(f"tag_{i},{num_tags - i}\n" for i in range(num_tags))
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:RES, 0:RES].astype(np.float32) / RES
    for i in range(N_IMAGES):
        phase = rng.uniform(0, 2 * np.pi, size=3)
        freq = rng.uniform(2, 12, size=3)
        img = np.stack([np.sin(freq[c] * (xx + yy * (c + 1)) * np.pi + phase[c])
                        for c in range(3)], -1) * 100 + 128
        img += rng.normal(0, 20, size=img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            WORK / "images" / f"img_{i:02d}.png")
    return dict(vae=str(WORK / "vae" / "diffusion_pytorch_model.safetensors"),
                config=str(WORK / "vae" / "config.json"),
                decoder=str(WORK / "pytorch_model.bin"),
                tags=str(WORK / "tags.csv"), images=str(WORK / "images"),
                out=str(WORK / "out"), num_tags=num_tags)


def phase_main_path():
    import numpy as np
    import torch
    from vae_tagger_tpu_torch.infer.__main__ import main as infer_main
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine
    from vae_tagger_tpu_torch.infer.pipeline import iter_image_batches
    from vae_tagger_tpu_torch.data.paths import get_image_paths
    from vae_tagger_tpu_torch.ops import backend

    log(f"main path: full FLUX VAE + attention head, {N_IMAGES} seeded "
        f"{RES}px PNGs, batch {BATCH}, bf16, through the infer CLI")
    t0 = time.perf_counter()
    art = _write_artifacts()
    log(f"  artifacts written in {time.perf_counter() - t0:.1f} s")
    argv = ["--vae_checkpoint", art["vae"], "--vae_config_path", art["config"],
            "--decoder_checkpoint", art["decoder"], "--image_path",
            art["images"], "--tags_csv_path", art["tags"], "--output_dir",
            art["out"], "--resolution", str(RES), "--batch_size", str(BATCH),
            "--mixed_precision", "bf16", "--num_workers", "4"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    out = infer_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = backend.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-N_IMAGES // BATCH)
    log(f"  CLI: {len(out)} images in {wall:.2f} s (load + decode + "
        f"{n_batches} batches), peak device memory {peak / 2**30:.2f} GiB")
    log(f"  launches in the main path: {counts}")

    with open(Path(art["out"]) / "classification_results.json") as f:
        on_disk = json.load(f)
    paths = [str(p) for p in get_image_paths(art["images"])]
    assert sorted(on_disk) == sorted(paths) and len(paths) == N_IMAGES, \
        "results JSON misses images"
    for r in on_disk.values():
        for key in ("max_confidence", "avg_confidence_top5"):
            assert np.isfinite(r[key]), r
    expect = {"group_norm_silu": 2 * n_batches,
              "gn_silu_conv3x3": B_PER_FORWARD * n_batches,
              "group_stats": B_PER_FORWARD * n_batches,
              "flash_attention_fwd": n_batches}
    for name, want in expect.items():
        assert counts[name] == want, (name, counts[name], want)

    # steady-state classify and the fp32 latent gate on one batch
    batch = next(iter(iter_image_batches(paths, RES, BATCH, 4, 1)))[2]
    kw = dict(vae_checkpoint=art["vae"], decoder_checkpoint=art["decoder"],
              tags_csv_path=art["tags"], vae_config_path=art["config"])
    eng16 = TaggerEngine.load(mixed_precision="bf16", **kw)
    probs = eng16.classify(batch)
    assert probs.shape == (BATCH, art["num_tags"]) and np.isfinite(probs).all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = 3
    for _ in range(iters):
        eng16.classify(batch)
    steady = iters * BATCH / (time.perf_counter() - t0)
    log(f"  steady-state classify, bf16: {steady:.3f} images/s "
        f"(host clock, {iters} batches of {BATCH}, host->device copy included)")
    lat16 = eng16.encode(batch)
    del eng16
    eng32 = TaggerEngine.load(mixed_precision="no", **kw)
    lat_k = eng32.encode(batch)
    with backend.backend("torch"):
        lat_t = eng32.encode(batch)
    mse = float(np.mean((lat_k - lat_t) ** 2))
    mse16 = float(np.mean((lat16 - lat_t) ** 2))
    log(f"  fp32 latents, kernel path vs torch path: MSE {mse:.3e} "
        f"(gate 1e-4); bf16 kernel path vs fp32 torch path: MSE {mse16:.3e}")
    assert np.isfinite(lat_k).all() and mse < 1e-4, mse
    del eng32
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    return dict(images=len(out), cli_wall_s=wall,
                cli_images_per_s=len(out) / wall,
                steady_images_per_s_bf16=steady, peak_mem_bytes=peak,
                launches=counts, expected_launches=expect,
                latent_mse_fp32_kernel_vs_torch=mse,
                latent_mse_bf16_kernel_vs_fp32_torch=mse16)


def _write_training_data(art):
    """The seeded images as a tagged dataset (data.json of weighted tag
    prompts over the 2,000 tags), and one tensor of a VAE decoder in the
    VAE checkpoint, which the trainer's export must keep unchanged."""
    import numpy as np
    import torch
    from safetensors.torch import load_file, save_file

    rng = np.random.default_rng(SEED + 3)
    data = {}
    for p in sorted(Path(art["images"]).glob("*.png")):
        # tags drawn from a pool of 24 so that triplets find positives
        tags = rng.choice(24, size=rng.integers(2, 6), replace=False)
        data[str(p)] = ", ".join(f"tag_{t}:{rng.uniform(0.5, 1.0):.2f}"
                                 for t in tags)
    path = WORK / "data.json"
    path.write_text(json.dumps(data, indent=1))
    state = load_file(art["vae"])
    extra = torch.randn(128, 16, 3, 3,
                        generator=torch.Generator().manual_seed(SEED + 4))
    state["decoder.conv_in.weight"] = extra
    save_file(state, art["vae"])
    return str(path), extra


def _kernel_breakdown(prof):
    """Device time of one profiled step by kernel: the port's kernels by
    name, everything else (cuDNN, cuBLAS, elementwise) as the rest."""
    names = {"conv3x3_kernel": "gn_silu_conv3x3",
             "gn_partial_kernel": "group_stats (+A's stats)",
             "gn_finalize_kernel": "group_stats (+A's stats)",
             "gn_apply_kernel": "group_norm_silu (apply)",
             "flash_fwd_kernel": "flash_attention_fwd",
             "flash_bwd_dq_kernel": "flash_attention_bwd_dq",
             "flash_bwd_dkv_kernel": "flash_attention_bwd_dkv"}
    from torch.autograd import DeviceType

    by_kernel, top = {}, []
    for evt in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' time
        us = getattr(evt, "self_device_time_total", 0) or 0
        if evt.device_type != DeviceType.CUDA or us <= 0:
            continue
        top.append((us / 1e3, evt.key[:90]))
        label = next((v for k, v in names.items() if k in evt.key),
                     "other (plain backward recompute, head, optimizer)")
        by_kernel[label] = by_kernel.get(label, 0.0) + us / 1e3
    top.sort(reverse=True)
    return by_kernel, top[:12]


# torch-path gradient norms below this are compared absolutely: two orders
# above the fp32 noise of structurally zero gradients, far below real ones
ZERO_GRAD_NORM = 1e-8


def _gradient_gate(art, batch):
    """One fp32 batch, the same weights and the same generator, through the
    kernel path and the torch backend: every parameter's gradient within
    1e-3 relative, or absolute where the torch path's gradient norm is
    below ZERO_GRAD_NORM.  Some gradients are zero in exact arithmetic and
    fp32 leaves rounding noise (~1e-10) on both paths: a key projection's
    bias (softmax ignores a shift shared by all keys) and, in train mode,
    the conv bias before a BatchNorm.  The head runs in eval mode for the
    latter (the encoder's gradient, from the triplet term, does not depend
    on the head's mode); the gate lists the parameters it compares
    absolutely."""
    import torch
    from vae_tagger_tpu_torch.infer.engine import build_decoder
    from vae_tagger_tpu_torch.io.checkpoints import load_decoder, load_vae
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.train.state import TrainState
    from vae_tagger_tpu_torch.train.steps import (
        FullSteps,
        batch_to_device,
        step_generator,
    )

    dev = torch.device("cuda")
    vae = load_vae(art["vae"], art["config"]).to(dev)
    head = load_decoder(build_decoder(NUM_TAGS, True, None, 16, SEED + 1),
                        art["decoder"]).to(dev)
    state = TrainState(vae=vae, decoder=head, optimizer=None)
    steps = FullSteps(LossConfig(triplet_weight=1.0, use_focal_loss=False),
                      compute_dtype=torch.float32, seed=SEED)
    dev_batch = batch_to_device(batch, dev)
    params = ([(f"vae.{n}", p) for n, p in vae.named_parameters()]
              + [(f"head.{n}", p) for n, p in head.named_parameters()])
    grads, losses = {}, {}
    for be in ("kernel", "torch"):
        for _, p in params:
            p.grad = None
        with backend.backend(be):
            total, _, _ = steps.forward_losses(
                state, dev_batch, step_generator(dev, SEED, 7), train=False)
            total.backward()
        torch.cuda.synchronize()
        losses[be] = total.item()
        missing = [n for n, p in params if p.grad is None]
        assert not missing, f"{be} path: no gradient for {missing[:5]}"
        grads[be] = {n: p.grad.detach().clone() for n, p in params}
    worst, errs, absolute, norms = ("", 0.0, 0.0), [], {}, []
    for n, _ in params:
        gt, gk = grads["torch"][n], grads["kernel"][n]
        diff, norm = (gk - gt).norm().item(), gt.norm().item()
        if norm < ZERO_GRAD_NORM:
            absolute[n] = (norm, diff)
            err = diff
        else:
            err = diff / norm
            norms.append(norm)
        errs.append(err)
        if err >= worst[1]:
            worst = (n, err, norm)
    log(f"  compared absolutely (torch-path norm < {ZERO_GRAD_NORM:g}): "
        f"{ {k: f'{a:.2e}/{b:.2e}' for k, (a, b) in absolute.items()} }; "
        f"smallest other norm {min(norms):.3e}")
    log(f"  gradient gate (fp32, {len(params)} parameters): loss kernel "
        f"{losses['kernel']:.6f} vs torch {losses['torch']:.6f}; worst "
        f"{worst[0]} {worst[1]:.3e} (torch-path norm {worst[2]:.3e}; gate "
        f"1e-3); median {sorted(errs)[len(errs) // 2]:.3e}")
    assert all(e <= 1e-3 for e in errs), worst
    del grads, state, vae, head
    torch.cuda.empty_cache()
    return dict(parameters=len(params), worst_param=worst[0],
                worst_err=worst[1], worst_param_grad_norm=worst[2],
                median_err=sorted(errs)[len(errs) // 2], losses=losses,
                compared_absolutely={k: dict(torch_norm=a, diff_norm=b)
                                     for k, (a, b) in absolute.items()},
                smallest_relative_norm=min(norms))


def phase_training():
    import numpy as np
    import torch
    from safetensors.torch import load_file
    from vae_tagger_tpu_torch.data.dataset import TaggedImageDataset
    from vae_tagger_tpu_torch.data.loader import DataLoader, train_val_split
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.train.steps import FullSteps
    from vae_tagger_tpu_torch.train.train_full import main as train_main

    log(f"training path: python -m vae_tagger_tpu_torch.train.train_full, "
        f"full FLUX VAE + attention head, {N_IMAGES} seeded {RES}px images "
        f"with {NUM_TAGS} tags, batch 1 (B={TRAIN_ROWS} stacked), bf16")
    art = _write_artifacts(NUM_TAGS)
    json_path, extra = _write_training_data(art)
    out = WORK / "train_out"
    argv = ["--json_path", json_path, "--tags_csv_path", art["tags"],
            "--vae_checkpoint", art["vae"], "--vae_config_path",
            art["config"], "--decoder_checkpoint", art["decoder"],
            "--output_dir", str(out), "--resolution", str(RES),
            "--train_batch_size", "1", "--num_epochs", "1",
            "--mixed_precision", "bf16", "--lr_warmup_steps", "0",
            "--save_steps", "1", "--logging_steps", "1", "--num_workers", "4",
            "--seed", str(SEED)]
    n_train, n_val = (len(ix) for ix in train_val_split(N_IMAGES, 0.1,
                                                        seed=SEED or 42))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    state = train_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = backend.launch_counts()
    cli_peak = torch.cuda.max_memory_allocated()
    log(f"  CLI: {n_train} train steps + {n_val} validation batch in "
        f"{wall:.2f} s (load, exports and checkpoints included), peak "
        f"device memory {cli_peak / 2**30:.2f} GiB")
    log(f"  launches in the training path: {counts}")
    expect = {k: n_train * TRAIN_STEP_LAUNCHES[k] + n_val * EVAL_LAUNCHES[k]
              for k in TRAIN_STEP_LAUNCHES}
    for name, want in expect.items():
        assert counts[name] == want, (name, counts[name], want)

    history = json.loads((out / "training_history.json").read_text())
    values = (history["train_loss"] + history["val_loss"]
              + [v for vs in history["train_metrics"].values() for v in vs])
    assert values and all(np.isfinite(values)), history
    log(f"  losses: train {history['train_loss']}, val "
        f"{history['val_loss']}, terms "
        f"{ {k: v for k, v in history['train_metrics'].items()} }")

    before_vae = load_file(art["vae"])
    after_vae = load_file(str(out / "vae" / "diffusion_pytorch_model.safetensors"))
    enc = [k for k in before_vae if k.startswith("encoder.")]
    same_vae = [k for k in enc if torch.equal(before_vae[k], after_vae[k])]
    before_head = torch.load(art["decoder"], weights_only=True)
    after_head = torch.load(out / "decoder" / "pytorch_model.bin",
                            weights_only=True)
    head_params = [n for n, _ in state.decoder.named_parameters()]
    same_head = [k for k in head_params
                 if torch.equal(before_head[k], after_head[k])]
    log(f"  parameters changed: encoder {len(enc) - len(same_vae)}/"
        f"{len(enc)}, head {len(head_params) - len(same_head)}/"
        f"{len(head_params)}")
    assert not same_vae and not same_head, (same_vae[:5], same_head[:5])
    assert torch.equal(after_vae["decoder.conv_in.weight"], extra), \
        "the export lost the VAE decoder tensor"

    eng = TaggerEngine.load(
        vae_checkpoint=str(out / "vae" / "diffusion_pytorch_model.safetensors"),
        decoder_checkpoint=str(out / "decoder" / "pytorch_model.bin"),
        tags_csv_path=art["tags"],
        vae_config_path=str(out / "vae" / "config.json"),
        mixed_precision="bf16")
    dataset = TaggedImageDataset(json_path, art["tags"], RES, seed=SEED)
    batch = next(iter(DataLoader(dataset, 1, shuffle=False, num_workers=1)))
    probs = eng.classify(batch["anchor"])
    assert probs.shape == (1, NUM_TAGS) and np.isfinite(probs).all()
    log(f"  exports classify through TaggerEngine: max probability "
        f"{probs.max():.4f}")
    del eng

    # steady step time on one batch, then one profiled step
    steps = FullSteps(LossConfig(triplet_weight=1.0, use_focal_loss=False),
                      compute_dtype=torch.bfloat16, seed=SEED)
    steps.train_step(state, batch, 1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    t0 = time.perf_counter()
    for i in range(iters):
        steps.train_step(state, batch, 1001 + i)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated()
    log(f"  steady train step, bf16: {step_s * 1e3:.1f} ms, "
        f"{TRAIN_ROWS / step_s:.3f} images/s ({TRAIN_ROWS} per step; host "
        f"clock, {iters} steps), peak device memory {peak / 2**30:.2f} GiB")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps.train_step(state, batch, 2000)
        torch.cuda.synchronize()
    by_kernel, top = _kernel_breakdown(prof)
    total_ms = sum(by_kernel.values())
    log(f"  one profiled step: {total_ms:.1f} ms of device time")
    for label, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        log(f"    {label}: {ms:.2f} ms")
    for ms, key in top:
        log(f"    top kernel {ms:.2f} ms: {key}")
    del state, steps, prof
    torch.cuda.empty_cache()

    gate = _gradient_gate(art, batch)
    shutil.rmtree(WORK, ignore_errors=True)
    return dict(train_steps=n_train, val_batches=n_val, cli_wall_s=wall,
                cli_peak_mem_bytes=cli_peak, launches=counts,
                expected_launches=expect, history=history,
                step_s_bf16=step_s, images_per_s_bf16=TRAIN_ROWS / step_s,
                step_peak_mem_bytes=peak, profiled_step_ms=total_ms,
                device_ms_by_kernel=by_kernel, top_kernels=top,
                gradient_gate=gate)


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, default=None,
                        help="also write the full report to this JSON file")
    args = parser.parse_args()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_card()
    report = {"card": smi, "build": phase_build()}
    g = torch.Generator().manual_seed(SEED)
    results = {}
    with torch.inference_mode():
        phase_kernel_a(g, results)
        phase_kernel_b(g, results)
        torch.cuda.empty_cache()
        phase_kernel_c(g, results)
    torch.cuda.empty_cache()
    with torch.no_grad():
        phase_kernel_de(g, results)
    report["autograd"] = phase_autograd(g)
    torch.cuda.empty_cache()
    report["main_path"] = phase_main_path()
    report["training"] = phase_training()
    report["kernels"] = results

    # launches: this slice's main path is training, which runs all six;
    # the inference path's counts stand beside them
    launches = report["training"]["launches"]
    infer_launches = report["main_path"]["launches"]
    kernels = []
    for name, meta in KERNELS.items():
        r = results[name]
        kernels.append(dict(
            name=name, **meta, launches=launches[name],
            launches_by_path={"train": launches[name],
                              "infer": infer_launches[name]},
            max_abs_err=r["max_abs_err"],
            max_rel_err_fp32=r["max_rel_err_fp32"],
            max_rel_err_bf16=r["max_rel_err_bf16"],
            plain_rel_err_bf16=r["plain_rel_err_bf16"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            per=r["per"]))
    report["kernel_line"] = kernels
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit as e:
        print(e, file=sys.stderr)
        sys.exit(1)
    except BaseException:  # any failed phase: traceback, non-zero, no ok line
        traceback.print_exc()
        sys.exit(1)
