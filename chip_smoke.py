#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vae_tagger_tpu_torch) on one GPU.

    python3 chip_smoke.py [--report PATH]

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout;
imports nothing of JAX or of the JAX package.  Phases, each fatal on
failure (non-zero exit, no ``ok`` line):

1. the card's name and power limit (nvidia-smi);
2. build every kernel of ``vae_tagger_tpu_torch/csrc`` (one nvcc per source,
   all at once) and print the build seconds and register use; no kernel
   may spill, and no build log may report a serialized wgmma (C7512/C7514);
3. kernel phases: each kernel against its plain PyTorch version on the card,
   at the encode path's shapes (batch 4 at 1024px), in fp32 (TF32 off) and
   bf16.  The dtype picks the kernel of the fused conv and the attention
   forward: bf16 runs the tensor-core kernels B' and C', fp32 the 3xTF32
   tensor-core kernels B'' and C''.  Each kernel is checked in the dtypes it
   runs (B' and C' bf16, B'' and C'' fp32, the others both), so every error
   it reports is its own.  fp32: max relative error <= 1e-4; B'' and C''
   also within 4x the error of the SIMT kernels B and C that they replaced
   (launched directly on the same inputs, and timed there as yardsticks),
   two launches bit-identical, and faster than B and C.  bf16: error against
   the plain fp32 result within 4x the plain version's own bf16 error (with a
   floor of 1e-4 where the plain version's arithmetic is fp32 whatever the
   input dtype).  Each kernel is timed with CUDA events in the dtype it
   runs (A and its stats pass in both), over about 100 ms of calls, beside
   its plain version and one PyTorch library call computing the same
   function (a yardstick only; the port never calls it).  A and its stats
   pass are also timed beside PR 1's SIMT kernels of csrc/groupnorm_silu.cu
   (launched directly on the same inputs; both passes must beat them), the
   stats pass site by site at the 20 stats sites of a forward, and both
   passes launch twice bit for bit at a 1024^2 C=128 and a 128^2 C=512
   site.  C' is also timed
   at the training step's B=3.  B'' and C'' get two bounds: fp32 FMA on the
   CUDA cores, and 3xTF32 on the tensor cores (three products at 495
   TFLOP/s), the one they are judged against.  The registers and shared
   memory a block of B', B'', C', C'', D', D'', E' and E'' are read from
   the CUDA runtime (cudaFuncGetAttributes).
   The flash-attention backward (bf16: D' for dQ and E' for dK/dV; fp32:
   the 3xTF32 kernels D'' and E''; E' and E'' run two passes, two
   launches) is checked the same way at the training step's shapes (B=3,
   S=16,384 and 4,096, D=512), each kernel twice more for bit-identical
   repeats, D'' and E'' also within 4x the error of the SIMT kernels D and
   E that they replaced (launched directly on the same fp32 inputs), and
   timed beside the backward of ``F.scaled_dot_product_attention``, whose
   backend is pinned to EFFICIENT_ATTENTION (the flash and cuDNN backends
   refuse D=512); D and E are timed on the same bf16 and fp32 inputs, and
   D' + E' and D'' + E'' must beat them;
4. autograd on the card: the outputs of A, B'' and C'' on tensors that require
   a gradient carry a ``grad_fn``, and each op's gradients through the
   kernel path match the torch backend in fp32 (relative error <= 1e-4);
   then the bf16 attention at the mid-block shape (C', D', E'): its
   gradients against the plain fp32 path within 4x the plain bf16 path's
   own error;
5. inference path: the full FLUX VAE (block_out_channels (128, 256, 512,
   512), 32 groups, 16 latent channels) and the default attention head on
   seeded random weights, written in diffusers layout and as
   pytorch_model.bin, then ``python -m vae_tagger_tpu_torch.infer``'s entry
   point on seeded 1024px PNGs at batch 4, in bf16 and then with no
   --mixed_precision flag (the CLI's default, fp32).  Checks of each run:
   every image in the JSON, finite probabilities, the exact launches per
   batch (bf16: A twice, its stats pass 20 times, B' 20 times and C' once;
   fp32: A twice, stats 20, B'' 20 and C'' once; every other kernel, the
   SIMT B and C among them, never); then the steady classify rate through
   ``TaggerEngine`` in bf16 over 50 batches and in fp32 over 10 (host
   clock), the fp32 rate also with the SIMT B and C in place of B'' and C''
   (the fp32 path before them, over 5 batches), and on one fp32 batch the
   same exact launches, fp32 latents of the kernel path within MSE 1e-10 of
   the plain (torch-backend) path, and the bf16 gate: the bf16 kernel
   path's latents against the fp32 plain path within 4x the MSE of the
   torch backend's own bf16 latents; then one fp32 batch and the steady
   fp32 rate with PyTorch's default cuDNN setting (TF32 on, which this
   script turns off elsewhere), its latents within BASELINE.json's MSE
   1e-4 of the TF32-off plain path;
6. training path: the same weights and images as a tagged dataset (2,000
   tags), then ``python -m vae_tagger_tpu_torch.train.train_full``'s entry
   point for one epoch at 1024px, batch 1 (a stacked triplet of 3 images),
   no warmup, in bf16 and then in fp32 (``--mixed_precision no``).  Checks
   of each: finite losses, the exact launch counts (per bf16 train step A
   2, stats 20, B' 20, C' 1, D' 1, E' 2; per fp32 step A 2, stats 20, B''
   20, C'' 1, D'' 1, E'' 2; every other kernel none; per validation batch
   the forward's), every encoder and head parameter changed, the VAE
   decoder tensor of the checkpoint kept by the export; the bf16 exports
   classify through ``TaggerEngine``.  Then the steady step time (bf16 over
   10 steps, fp32 over 4), images/s and peak memory, a profiler breakdown
   of one step of each by kernel, the fp32 step again with the SIMT D and
   E in place of D'' and E'' (over 3 steps), and the gradient gate: on one
   fp32 batch, every parameter's gradient through the kernel path (A,
   stats, B'', C'', D'' and E'', with exact launch counts) within 1e-3 of
   the torch backend's, relative, or absolute where the torch path's norm
   is below 1e-8 (gradients that are zero in exact arithmetic);
7. kernel A's device time by kernel (torch.profiler), new and PR 1's, at
   each stats site with its bandwidth, and of A's two passes: last, since a
   profiler session may slow the host's launches after it;
8. one JSON line ``{"kernels": [...]}``, then as the last line
   ``{"ok": true, "device": {...}}``.

With ``--report PATH`` the full report is also written there as JSON.
"""

from __future__ import annotations

import contextlib
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

# Published H100 SXM peaks (dense): bf16 and TF32 tensor cores, fp32 CUDA
# cores, HBM3.  "tf32x3" is fp32 work done as three TF32 products (B'',
# C''): the FLOP are counted once and the rate is a third of TF32's.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
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
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/groupnorm_silu_vec.cu",
        replaces="vae_tagger_tpu/ops/pallas/groupnorm_silu.py:122 and :213"),
    "group_stats": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/groupnorm_silu_vec.cu",
        replaces="vae_tagger_tpu/ops/conv.py:235 and :244 (group_stats and "
                 "effective_affine, fed to the fused conv; kernel A's stats "
                 "pass)"),
    "gn_silu_conv3x3_tf32x3": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/gn_silu_conv3x3_tf32x3.cu",
        replaces="vae_tagger_tpu/ops/pallas/conv_fused.py:173 (fp32 path, "
                 "pallas_call at :260)"),
    "gn_silu_conv3x3_tc": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/gn_silu_conv3x3_tc.cu",
        replaces="vae_tagger_tpu/ops/pallas/conv_fused.py:173 (bf16 path, "
                 "pallas_call at :260)"),
    "flash_attention_fwd_tf32x3": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/flash_attention_fwd_tf32x3.cu",
        replaces="vae_tagger_tpu/ops/pallas/flash_attention.py:87 (fp32 "
                 "path, pallas_call at :112)"),
    "flash_attention_fwd_tc": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/flash_attention_fwd_tc.cu",
        replaces="vae_tagger_tpu/ops/pallas/flash_attention.py:87 (bf16 "
                 "path, pallas_call at :112)"),
    "flash_attention_bwd_dq_tf32x3": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/flash_attention_bwd_tf32x3.cu",
        replaces="vae_tagger_tpu/ops/pallas/flash_attention.py:154 "
                 "(_bwd_dq_kernel, pallas_call at :265; fp32 path)"),
    "flash_attention_bwd_dq_tc": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/flash_attention_bwd_tc.cu",
        replaces="vae_tagger_tpu/ops/pallas/flash_attention.py:154 "
                 "(_bwd_dq_kernel, pallas_call at :265; bf16 path)"),
    "flash_attention_bwd_dkv_tf32x3": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/flash_attention_bwd_tf32x3.cu",
        replaces="vae_tagger_tpu/ops/pallas/flash_attention.py:187 "
                 "(_bwd_dkv_kernel, pallas_call at :296; fp32 path)"),
    "flash_attention_bwd_dkv_tc": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/flash_attention_bwd_tc.cu",
        replaces="vae_tagger_tpu/ops/pallas/flash_attention.py:187 "
                 "(_bwd_dkv_kernel, pallas_call at :296; bf16 path)"),
}
# the path whose launches a kernel's line reports: the fp32 kernels run on
# fp32 paths only (bf16 paths run B', C', D' and E'): B'' and C'' on the
# infer CLI at its default precision, D'' and E'' in fp32 training
KERNEL_PATH = {"gn_silu_conv3x3_tf32x3": "infer_fp32",
               "flash_attention_fwd_tf32x3": "infer_fp32",
               "flash_attention_bwd_dq_tf32x3": "train_fp32",
               "flash_attention_bwd_dkv_tf32x3": "train_fp32"}
# the SIMT kernels that B'', C'', D'' and E'' replaced: no longer
# dispatched, launched directly (_simt_conv, _simt_fwd, _simt_bwd) on the
# same fp32 inputs as yardsticks
SIMT_PREDECESSOR = {"gn_silu_conv3x3_tf32x3": "B (csrc/gn_silu_conv3x3.cu)",
                    "flash_attention_fwd_tf32x3":
                        "C (csrc/flash_attention_fwd.cu)",
                    "flash_attention_bwd_dq_tf32x3":
                        "D (csrc/flash_attention_bwd.cu)",
                    "flash_attention_bwd_dkv_tf32x3":
                        "E (csrc/flash_attention_bwd.cu)"}
# launches of one encode batch, bf16 and fp32
ENCODE_LAUNCHES = {
    "bf16": {"group_norm_silu": 2, "group_stats": 20, "gn_silu_conv3x3_tc": 20,
             "flash_attention_fwd_tc": 1},
    "fp32": {"group_norm_silu": 2, "group_stats": 20,
             "gn_silu_conv3x3_tf32x3": 20, "flash_attention_fwd_tf32x3": 1},
}
# launches of one train step: the encode's, then the attention backward (E'
# and E'' each run a dV pass and a dK pass); a validation batch runs the
# encode's alone
TRAIN_STEP_LAUNCHES = {
    "bf16": dict(ENCODE_LAUNCHES["bf16"], flash_attention_bwd_dq_tc=1,
                 flash_attention_bwd_dkv_tc=2),
    "fp32": dict(ENCODE_LAUNCHES["fp32"], flash_attention_bwd_dq_tf32x3=1,
                 flash_attention_bwd_dkv_tf32x3=2),
}
# launches of the fp32 gradient gate's kernel-path forward and backward
GATE_LAUNCHES = TRAIN_STEP_LAUNCHES["fp32"]


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

def time_ms(fn, window_ms=100.0, max_iters=50):
    """Mean device time of fn() after one warm-up call, over as many calls
    as fill about window_ms by a first timed call (at least 3, at most
    max_iters)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    first = start.elapsed_time(end)
    iters = int(min(max_iters, max(3, window_ms / max(first, 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, ref):
    """max |a - ref| over max |ref|, in fp64 where ref is fp64, else fp32."""
    import torch

    dt = torch.float64 if ref.dtype == torch.float64 else torch.float32
    ref = ref.to(dt)
    return ((a.to(dt) - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def abs_err(a, ref):
    return (a.float() - ref.float()).abs().max().item()


class Check:
    """One kernel vs its plain version on the same inputs, in the dtypes
    that kernel runs ("fp32", "bf16"), so that every error it reports is
    that kernel's own."""

    def __init__(self, name, dtypes=("fp32", "bf16")):
        self.name = name
        self.dtypes = dtypes
        self.rows = []

    def run(self, label, op):
        """op(dtype) -> tensor or tuple of tensors.  The inputs op closes
        over are bf16-representable, so both dtypes see the same values;
        the plain fp32 result is the reference of both, and is returned
        (a tuple)."""
        import torch
        from vae_tagger_tpu_torch.ops import backend

        def outs(dt, be):
            with backend.backend(be):
                r = op(dt)
            torch.cuda.synchronize()
            return r if isinstance(r, tuple) else (r,)

        def finite(t):
            return bool(torch.isfinite(t).all())

        p32 = outs(torch.float32, "torch")
        if "fp32" in self.dtypes:
            k32 = outs(torch.float32, "kernel")
        if "bf16" in self.dtypes:
            p16 = outs(torch.bfloat16, "torch")
            k16 = outs(torch.bfloat16, "kernel")
        for i, ref in enumerate(p32):
            row, ok, said = dict(case=f"{label}[{i}]"), True, []
            if "fp32" in self.dtypes:
                e32, a32 = rel_err(k32[i], ref), abs_err(k32[i], ref)
                ok = ok and e32 <= 1e-4 and finite(k32[i])
                row.update(rel_err_fp32=e32, abs_err_fp32=a32)
                said.append(f"fp32 rel {e32:.3e} (abs {a32:.3e})")
            if "bf16" in self.dtypes:
                ek, ep = rel_err(k16[i], ref), rel_err(p16[i], ref)
                tol16 = max(4 * ep, 1e-4)
                ok = ok and ek <= tol16 and finite(k16[i])
                row.update(rel_err_bf16=ek, abs_err_bf16=abs_err(k16[i], ref),
                           plain_rel_err_bf16=ep, tol_bf16=tol16)
                said.append(f"bf16 rel {ek:.3e} vs plain {ep:.3e} "
                            f"(tol {tol16:.3e})")
            row["ok"] = ok
            self.rows.append(row)
            log(f"  {self.name} {row['case']}: {'; '.join(said)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{self.name} {label}: kernel disagrees "
                                     f"with its plain version: {row}")
        return p32

    def summary(self):
        """Worst errors over the cases, None for a dtype the kernel does
        not run; ``max_abs_err`` is that of the fp32 rows where the kernel
        runs fp32, else of the bf16 rows."""
        def worst(key):
            vals = [r[key] for r in self.rows if key in r]
            return max(vals) if vals else None

        abs_of = "fp32" if "fp32" in self.dtypes else "bf16"
        return dict(max_abs_err=worst(f"abs_err_{abs_of}"),
                    max_rel_err_fp32=worst("rel_err_fp32"),
                    max_rel_err_bf16=worst("rel_err_bf16"),
                    plain_rel_err_bf16=worst("plain_rel_err_bf16"),
                    cases=len(self.rows))


def time_kernel(op, dt, library=None):
    """ms of op(dt) on the kernel backend and on the torch backend (the
    plain version), and ms of library() where there is one."""
    from vae_tagger_tpu_torch.ops import backend

    fn = lambda: op(dt)  # noqa: E731
    ms = time_ms(fn)
    with backend.backend("torch"):
        plain_ms = time_ms(fn)
    return ms, plain_ms, None if library is None else time_ms(library)


def sdpa(q, k, v):
    """F.scaled_dot_product_attention on (B, S, D) tensors, pinned to the
    EFFICIENT_ATTENTION backend: the flash and cuDNN backends refuse
    D=512.  A yardstick only; the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q[:, None], k[:, None],
                                              v[:, None])


SDPA_NAME = "F.scaled_dot_product_attention, EFFICIENT_ATTENTION backend"


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
    ints = re.match(r"I((?:Li\d+E)+)E", args)
    if ints:  # e.g. <512> or <256, 2>: tile widths and variants
        return f"{name}<{', '.join(re.findall(r'Li(\d+)E', ints.group(1)))}>"
    t = re.match(r"I(13__nv_bfloat16|f)((?:L[bi]\d+E)*)", args)
    if not t:
        return name
    dtype = "bf16" if t.group(1) != "f" else "f32"
    params = re.findall(r"L[bi](\d+)E", t.group(2))
    return f"{name}<{', '.join([dtype, *params])}>"


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
    # every kernel without spills, and no wgmma serialized by ptxas
    spilled = {fn: r["spill_stores"] for fn, r in resources.items()
               if r.get("spill_stores")}
    serialized = [ln.strip() for rec in built.values()
                  for ln in rec["log"].splitlines()
                  if re.search(r"C751[24]", ln)]
    assert not spilled and not serialized, (spilled, serialized)
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
    """Kernel A (GroupNorm(+SiLU): the stats pass, then the apply pass) at
    the mid-block and conv_norm_out sites, against its plain version, in
    bf16 and fp32; timed in both dtypes beside PR 1's kernels on the same
    inputs (which it must beat), the plain version and F.group_norm +
    F.silu."""
    import torch
    import torch.nn.functional as F
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.normalization import group_norm_silu

    log("kernel A: group_norm_silu at the mid-block and conv_norm_out sites; "
        "PR 1's kernels on the same inputs")
    chk = Check("group_norm_silu")
    shape = (BATCH, RES // 8, RES // 8, 512)
    x = _rnd(g, *shape, shift=0.5)
    xs = _both(x)
    sc = _rnd(g, 512, scale=0.2, shift=1.0)
    bi = _rnd(g, 512, scale=0.1)
    tot = {dt: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, pr1_ms=0.0)
           for dt in xs}
    for silu in (False, True):
        def op(dt, silu=silu):
            return group_norm_silu(xs[dt], sc, bi, num_groups=GROUPS,
                                   apply_silu=silu)

        chk.run(f"{shape} silu={silu}", op)
        for dt, t in tot.items():
            def library(dt=dt, silu=silu):
                y = F.group_norm(xs[dt].permute(0, 3, 1, 2), GROUPS,
                                 sc.to(dt), bi.to(dt), 1e-6)
                return F.silu(y) if silu else y

            t["ms"] += time_ms(lambda: op(dt))
            with backend.backend("torch"):
                t["plain_ms"] += time_ms(lambda: op(dt))
            t["library_ms"] += time_ms(library)
            t["pr1_ms"] += time_ms(lambda: _pr1_group_norm_silu(
                xs[dt], sc, bi, silu))
    out = {}
    for dt, t in tot.items():
        # two calls, each reading x once and writing out once; the
        # arithmetic is fp32 on the CUDA cores
        nbytes = 2 * 2 * x.numel() * xs[dt].element_size()
        b_ms, b_by = bound(nbytes, 2 * 10 * x.numel(), "float32")
        out[dt] = dict(t, bound_ms=b_ms, bound_by=b_by)
        log(f"  A, {dt}, 2 calls: {t['ms']:.4f} ms, PR 1's kernels "
            f"{t['pr1_ms']:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_ms / t['ms']:.1%}); plain "
            f"{t['plain_ms']:.4f}, F.group_norm + F.silu "
            f"{t['library_ms']:.4f} ms")
        assert t["ms"] < t["pr1_ms"], (dt, t)
    bf, f32 = out[torch.bfloat16], out[torch.float32]
    results["group_norm_silu"] = dict(
        chk.summary(), ms=bf["ms"], plain_ms=bf["plain_ms"],
        library_ms=bf["library_ms"], bound_ms=bf["bound_ms"],
        bound_by=bf["bound_by"], pr1_ms=bf["pr1_ms"], ms_fp32=f32["ms"],
        plain_ms_fp32=f32["plain_ms"], library_ms_fp32=f32["library_ms"],
        bound_ms_fp32=f32["bound_ms"], pr1_ms_fp32=f32["pr1_ms"],
        library="F.group_norm + F.silu (channels_last)",
        per=f"2 calls (4 launches): one batch of {BATCH} at {RES}px; ms, "
            f"plain_ms, library_ms and bound_ms bf16, *_fp32 fp32")


def _fp32_bounds(nbytes, flops):
    """The two bounds of an fp32 kernel: (ms, by) on the CUDA cores' fp32
    FMA, and (ms, by) as 3xTF32 on the tensor cores (3 x FLOP at 495
    TFLOP/s), the one B'' and C'' are judged against."""
    return bound(nbytes, flops, "float32"), bound(nbytes, flops, "tf32x3")


def _same_twice(fn):
    """Two launches of fn() on the same inputs are bit-identical."""
    import torch

    first, second = fn(), fn()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def phase_kernel_b(g, results):
    import torch
    import torch.nn.functional as F
    from vae_tagger_tpu_torch.ops.conv import gn_silu_conv3x3, tc_kernel_attrs
    from vae_tagger_tpu_torch.ops.normalization import group_norm_affine

    log(f"kernels B' (bf16) and B'' (fp32): gn_silu_conv3x3 at the "
        f"{B_PER_FORWARD} encoder convs, the SIMT kernel B on the same fp32 "
        f"inputs; kernel A's stats pass (group_stats) checked on their "
        f"inputs (timed in phase_stats_sites)")
    dts = {"gn_silu_conv3x3_tc": torch.bfloat16,
           "gn_silu_conv3x3_tf32x3": torch.float32}
    chk = {"gn_silu_conv3x3_tc": Check("gn_silu_conv3x3_tc", ("bf16",)),
           "gn_silu_conv3x3_tf32x3": Check("gn_silu_conv3x3_tf32x3",
                                           ("fp32",))}
    chk_s = Check("group_stats")
    tot = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0,
                      nbytes=0.0) for name in dts}
    simt = dict(ms=0.0, rel_errs=[])
    # the instances of B' and B'': what the CUDA runtime reports for each
    attrs = {torch.bfloat16: {}, torch.float32: {}}
    for hw, cin, cout, variant, cres, mult in B_CASES:
        for dt, found in attrs.items():
            a = tc_kernel_attrs(cout, variant, dt)
            found[f"bn={a['bn']} {variant}"] = a
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
        chk["gn_silu_conv3x3_tc"].run(label, op)
        ref = chk["gn_silu_conv3x3_tf32x3"].run(label, op)[0]
        # the SIMT kernel B on the same fp32 inputs: B'' must not be less
        # accurate than 4x B, and launches twice bit for bit
        new_err = chk["gn_silu_conv3x3_tf32x3"].rows[-1]["rel_err_fp32"]

        def simt_op():
            return _simt_conv(x, gs, gb, k, b, res, sck, scb)

        simt_err = rel_err(simt_op(), ref)
        same = _same_twice(lambda: op(torch.float32))
        log(f"  gn_silu_conv3x3_tf32x3 {label}: fp32 rel {new_err:.3e}, the "
            f"SIMT kernel B's {simt_err:.3e} (gate 4x); two launches "
            f"bit-identical: {same}")
        assert new_err <= 4 * simt_err and same, (label, new_err, simt_err)
        simt["rel_errs"].append(simt_err)
        del ref

        def stats_op(dt):
            return group_norm_affine(xs[dt], gs, gb, num_groups=GROUPS)

        chk_s.run(label, stats_op)

        def library(dt):
            xd, rd = xs[dt], rs[dt]
            w_oihw = k.to(dt).permute(3, 2, 0, 1).contiguous()
            sc_oihw = (None if sck is None
                       else sck.to(dt).t()[:, :, None, None].contiguous())

            def call():
                y = F.silu(F.group_norm(xd.permute(0, 3, 1, 2), GROUPS,
                                        gs.to(dt), gb.to(dt), 1e-6))
                out = F.conv2d(y, w_oihw, b.to(dt), padding=1)
                if sc_oihw is not None:
                    out = out + F.conv2d(rd.permute(0, 3, 1, 2), sc_oihw,
                                         scb.to(dt))
                elif rd is not None:
                    out = out + rd.permute(0, 3, 1, 2)
                return out
            return call

        m = BATCH * hw * hw
        k_dim = 9 * cin + (cres if variant == "shortcut" else 0)
        for name, dt in dts.items():
            ms, plain_ms, lib_ms = time_kernel(op, dt, library(dt))
            esize = 2.0 if dt == torch.bfloat16 else 4.0
            t = tot[name]
            t["ms"] += mult * ms
            t["plain_ms"] += mult * plain_ms
            t["library_ms"] += mult * lib_ms
            t["flops"] += mult * 2.0 * m * k_dim * cout
            t["nbytes"] += mult * esize * (m * cin + m * cout
                                           + (m * cres if cres else 0)
                                           + k_dim * cout)
        simt["ms"] += mult * time_ms(simt_op, max_iters=5)
        del x, xs, res, rs
        torch.cuda.empty_cache()
    log(f"  B' instances (cudaFuncGetAttributes): {attrs[torch.bfloat16]}")
    log(f"  B'' instances (cudaFuncGetAttributes): {attrs[torch.float32]}")
    library = ("F.group_norm + F.silu + cuDNN F.conv2d + residual add or 1x1 "
               "F.conv2d (NCHW views of channels_last tensors)")
    per = f"{B_PER_FORWARD} launches: one batch of {BATCH} at {RES}px"
    t = tot["gn_silu_conv3x3_tc"]
    b_ms, b_by = bound(t["nbytes"], t["flops"])
    results["gn_silu_conv3x3_tc"] = dict(
        chk["gn_silu_conv3x3_tc"].summary(), ms=t["ms"],
        plain_ms=t["plain_ms"], library_ms=t["library_ms"], bound_ms=b_ms,
        bound_by=b_by, flops=t["flops"], runtime_attrs=attrs[torch.bfloat16],
        library=library, per=f"{per}, bfloat16")
    t = tot["gn_silu_conv3x3_tf32x3"]
    (c_ms, c_by), (b_ms, b_by) = _fp32_bounds(t["nbytes"], t["flops"])
    log(f"  B'' {t['ms']:.3f} ms, the SIMT kernel B {simt['ms']:.3f} ms, "
        f"cuDNN fp32 {t['library_ms']:.3f} ms; bound {b_ms:.3f} ms as 3xTF32 "
        f"({b_ms / t['ms']:.1%}), {c_ms:.3f} ms on the CUDA cores")
    assert t["ms"] < simt["ms"], (t["ms"], simt["ms"])
    results["gn_silu_conv3x3_tf32x3"] = dict(
        chk["gn_silu_conv3x3_tf32x3"].summary(), ms=t["ms"],
        plain_ms=t["plain_ms"], library_ms=t["library_ms"], bound_ms=b_ms,
        bound_by=b_by, bound_ms_cuda_cores=c_ms, bound_by_cuda_cores=c_by,
        flops=t["flops"], simt_ms=simt["ms"],
        simt_max_rel_err_fp32=max(simt["rel_errs"]),
        bit_identical_repeats=len(B_CASES),
        runtime_attrs=attrs[torch.float32], library=f"{library}, TF32 off",
        per=f"{per}, float32")
    results["group_stats"] = chk_s.summary()


def phase_kernel_c(g, results):
    import torch
    from vae_tagger_tpu_torch.ops.attention import (
        flash_attention_fwd,
        fwd_tc_kernel_attrs,
    )

    log("kernels C' (bf16) and C'' (fp32): flash_attention_fwd, one head, "
        "D=512; the SIMT kernel C on the same fp32 inputs")
    d = 512
    dts = {"flash_attention_fwd_tc": torch.bfloat16,
           "flash_attention_fwd_tf32x3": torch.float32}
    chk = {"flash_attention_fwd_tc": Check("flash_attention_fwd_tc",
                                           ("bf16",)),
           "flash_attention_fwd_tf32x3": Check("flash_attention_fwd_tf32x3",
                                               ("fp32",))}
    attrs = {name: fwd_tc_kernel_attrs(dt) for name, dt in dts.items()}
    log(f"  C' and C'' (cudaFuncGetAttributes): {attrs}")
    timed, simt_errs = {}, []
    # the mid-block sequence at 512px and 1024px, and the train step's B=3
    for b, s in ((BATCH, (RES // 16) ** 2), (BATCH, (RES // 8) ** 2),
                 (TRAIN_ROWS, (RES // 8) ** 2)):
        qs, ks, vs = (_both(_rnd(g, b, s, d)) for _ in range(3))
        f32 = (qs[torch.float32], ks[torch.float32], vs[torch.float32])

        def op(dt):
            return flash_attention_fwd(qs[dt], ks[dt], vs[dt])

        label = f"B={b} S={s}"
        chk["flash_attention_fwd_tc"].run(label, op)
        ref = chk["flash_attention_fwd_tf32x3"].run(label, op)
        rows = chk["flash_attention_fwd_tf32x3"].rows[-len(ref):]
        new_err = max(r["rel_err_fp32"] for r in rows)
        simt_err = max(rel_err(o, r) for o, r in zip(_simt_fwd(*f32), ref))
        same = _same_twice(lambda: op(torch.float32))
        log(f"  flash_attention_fwd_tf32x3 {label}: fp32 rel {new_err:.3e}, "
            f"the SIMT kernel C's {simt_err:.3e} (gate 4x); two launches "
            f"bit-identical: {same}")
        assert new_err <= 4 * simt_err and same, (label, new_err, simt_err)
        simt_errs.append(simt_err)
        del ref
        full = s == (RES // 8) ** 2
        if full and b == BATCH:
            for name, dt in dts.items():
                esize = 2.0 if dt == torch.bfloat16 else 4.0
                ms, plain_ms, lib_ms = time_kernel(
                    op, dt, lambda dt=dt: sdpa(qs[dt], ks[dt], vs[dt]))
                nbytes = esize * 4 * b * s * d + 4.0 * b * s
                flops = 4.0 * b * s * s * d
                timed[name] = dict(ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, flops=flops)
                if dt == torch.bfloat16:
                    b_ms, b_by = bound(nbytes, flops)
                    dname = "bfloat16"
                else:
                    (c_ms, c_by), (b_ms, b_by) = _fp32_bounds(nbytes, flops)
                    timed[name].update(bound_ms_cuda_cores=c_ms,
                                       bound_by_cuda_cores=c_by)
                    dname = "float32"
                timed[name].update(bound_ms=b_ms, bound_by=b_by,
                                   per=f"1 launch: one batch of {b} at "
                                       f"{RES}px (S={s}), {dname}")
            simt_ms = time_ms(lambda: _simt_fwd(*f32), max_iters=5)
            t = timed["flash_attention_fwd_tf32x3"]
            t["simt_ms"] = simt_ms
            log(f"  C'' {t['ms']:.3f} ms, the SIMT kernel C {simt_ms:.3f} ms, "
                f"SDPA fp32 {t['library_ms']:.3f} ms; bound "
                f"{t['bound_ms']:.3f} ms as 3xTF32 "
                f"({t['bound_ms'] / t['ms']:.1%}), "
                f"{t['bound_ms_cuda_cores']:.3f} ms on the CUDA cores")
            assert t["ms"] < simt_ms, (t["ms"], simt_ms)
        elif full:
            fn = lambda: op(torch.bfloat16)  # noqa: E731
            b_ms, _ = bound(2.0 * 4 * b * s * d + 4.0 * b * s,
                            4.0 * b * s * s * d)
            timed["flash_attention_fwd_tc"]["train_step"] = dict(
                ms=time_ms(fn), bound_ms=b_ms,
                library_ms=time_ms(lambda: sdpa(qs[torch.bfloat16],
                                                ks[torch.bfloat16],
                                                vs[torch.bfloat16])),
                per=f"1 launch: one train step at batch 1 (B={b}, S={s})")
        del qs, ks, vs, f32
        torch.cuda.empty_cache()
    for name, c in chk.items():
        results[name] = dict(c.summary(), **timed[name], library=SDPA_NAME,
                             runtime_attrs=attrs[name])
    results["flash_attention_fwd_tf32x3"].update(
        simt_max_rel_err_fp32=max(simt_errs), bit_identical_repeats=3)


def _simt_conv(x, gs, gb, kern, bias, res=None, sck=None, scb=None,
               num_groups=GROUPS, eps=1e-6):
    """Kernel B (SIMT, fp32) launched directly on fp32 tensors, which the
    port sends to B'': the yardstick B'' must beat on the same inputs.
    Kernel A's stats pass gives it the folded GroupNorm affine, as in the
    port."""
    import torch
    from vae_tagger_tpu_torch.ops import _build
    from vae_tagger_tpu_torch.ops.normalization import group_norm_affine

    n, h, w, c_in = x.shape
    c_out = kern.shape[-1]
    c_res = 0 if res is None else res.shape[-1]
    es, eb = group_norm_affine(x, gs, gb, num_groups=num_groups, eps=eps)
    wmat = kern.reshape(9 * c_in, c_out).contiguous()
    wsc = None if sck is None else sck.reshape(c_res, c_out).contiguous()
    out = torch.empty(n, h, w, c_out, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.check(_build.lib("gn_silu_conv3x3").vt_gn_silu_conv3x3(
        x.data_ptr(), 0, n, h, w, c_in, c_out, es.data_ptr(), eb.data_ptr(),
        wmat.data_ptr(), bias.data_ptr(), ptr(res), c_res, ptr(wsc),
        ptr(scb), out.data_ptr(), _build.stream_of(x)), "vt_gn_silu_conv3x3")
    return out


def _pr1_stats_chunks(n, s, c):
    """The PR 1 stats pass's row chunks per sample: about 2,048 blocks of
    32 channels in all, at least 64 rows per chunk."""
    strips = -(-c // 32)
    chunks = max(1, -(-2048 // (n * strips)))
    return min(chunks, max(1, -(-s // 64)))


def _pr1_stats(x, gs=None, gb=None, num_groups=GROUPS, eps=1e-6):
    """Kernel A's stats pass as PR 1 wrote it (``gn_partial_kernel`` and
    ``gn_finalize_kernel`` of csrc/groupnorm_silu.cu), launched directly
    with the PR 1 wrapper's allocations: the yardstick of the stats pass.
    Returns (mean, meansq, eff_scale, eff_bias); the last two are None
    without gs/gb."""
    import torch
    from vae_tagger_tpu_torch.ops import _build

    n, h, w, c = x.shape
    s = h * w
    chunks = _pr1_stats_chunks(n, s, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty(n * chunks * 2 * c, **f32)
    mean = torch.empty(n, num_groups, **f32)
    meansq = torch.empty(n, num_groups, **f32)
    es = eb = None
    if gs is not None:
        es, eb = torch.empty(n, c, **f32), torch.empty(n, c, **f32)
    _build.check(_build.lib("groupnorm_silu").vt_gn_stats(
        x.data_ptr(), _build.dtype_code(x), n, s, c, num_groups, chunks,
        None if gs is None else gs.data_ptr(),
        None if gb is None else gb.data_ptr(), float(eps),
        partial.data_ptr(), mean.data_ptr(), meansq.data_ptr(),
        None if es is None else es.data_ptr(),
        None if eb is None else eb.data_ptr(), _build.stream_of(x)),
        "vt_gn_stats")
    return mean, meansq, es, eb


def _pr1_group_norm_silu(x, gs, gb, apply_silu=True, num_groups=GROUPS,
                         eps=1e-6):
    """Kernel A's GroupNorm(+SiLU) as PR 1 wrote it: its stats pass, then
    ``gn_apply_kernel``, launched directly; the yardstick of A."""
    import torch
    from vae_tagger_tpu_torch.ops import _build

    n, h, w, c = x.shape
    _, _, es, eb = _pr1_stats(x, gs, gb, num_groups, eps)
    out = torch.empty_like(x)
    _build.check(_build.lib("groupnorm_silu").vt_gn_apply(
        x.data_ptr(), _build.dtype_code(x), n, h * w, c, es.data_ptr(),
        eb.data_ptr(), out.data_ptr(), int(bool(apply_silu)),
        _build.stream_of(x)), "vt_gn_apply")
    return out


def _device_ms_by_kernel(fn, reps=10):
    """Device time of one call of fn() by kernel name, from torch.profiler
    over ``reps`` calls after a warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if evt.device_type != DeviceType.CUDA or us <= 0:
            continue
        name = re.search(r"(\w+_kernel)", evt.key)
        key = name.group(1) if name else evt.key[:60]
        out[key] = out.get(key, 0.0) + us / 1e3 / reps
    return out


def _stats_shapes():
    """{(H=W, C): stats sites of one forward} of the inputs of B_CASES."""
    shapes = {}
    for hw, cin, *_, mult in B_CASES:
        shapes[(hw, cin)] = shapes.get((hw, cin), 0) + mult
    return shapes


def phase_stats_sites(g, results):
    """Kernel A's stats pass at each of the 20 stats sites of one 1024px
    forward (the inputs of B_CASES, one row per input shape), in bf16 and
    fp32: one call's time as the timing loop sees it (CUDA events; host
    allocation and the ctypes call included), beside PR 1's pass on the same
    inputs, the plain version and the library call.  The new pass must be
    faster than PR 1's per batch in both dtypes.  At one 1024^2 C=128 site
    and one 128^2 C=512 site, two launches of each pass (group_stats,
    group_norm_affine, group_norm_silu) are bit-identical.  (Device time by
    kernel comes last, in phase_device_breakdown: a profiler session may
    slow the host's launches after it.)"""
    import torch
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.normalization import (
        group_norm_affine,
        group_norm_silu,
        group_stats,
    )

    log("kernel A's stats pass, site by site (the 20 stats sites of one "
        f"{RES}px forward, batch {BATCH}): one call in the timing loop (CUDA "
        "events, host work included), PR 1's pass on the same inputs")
    rows, repeats = [], []
    tot = {dt: dict(ms=0.0, pr1_ms=0.0, plain_ms=0.0, library_ms=0.0,
                    nbytes=0.0) for dt in ("bfloat16", "float32")}
    for (hw, cin), sites in _stats_shapes().items():
        x = _rnd(g, BATCH, hw, hw, cin, shift=0.3)
        gs = _rnd(g, cin, scale=0.2, shift=1.0)
        gb = _rnd(g, cin, scale=0.1)
        for dt in (torch.bfloat16, torch.float32):
            xd = x.to(dt)
            dname = str(dt).removeprefix("torch.")
            nbytes = xd.numel() * xd.element_size()

            def new():
                return group_norm_affine(xd, gs, gb, num_groups=GROUPS)

            row = dict(hw=hw, c=cin, dtype=dname, sites=sites, bytes=nbytes,
                       bound_ms=nbytes / PEAK_BYTES * 1e3, ms=time_ms(new),
                       pr1_ms=time_ms(lambda: _pr1_stats(xd, gs, gb)))
            with backend.backend("torch"):
                row["plain_ms"] = time_ms(new)
            row["library_ms"] = time_ms(lambda: torch.var_mean(
                xd.view(BATCH, hw * hw, GROUPS, -1).float(), dim=(1, 3),
                correction=0))
            log(f"  {hw}^2 C={cin} {dname} x{sites} (bound "
                f"{row['bound_ms']:.4f} ms): {row['ms']:.4f} ms "
                f"({row['bound_ms'] / row['ms']:.0%} of bound), PR 1 "
                f"{row['pr1_ms']:.4f}, plain {row['plain_ms']:.4f}, "
                f"torch.var_mean {row['library_ms']:.4f} ms")
            t = tot[dname]
            for key in ("ms", "pr1_ms", "plain_ms", "library_ms"):
                t[key] += sites * row[key]
            t["nbytes"] += sites * nbytes
            rows.append(row)
            if (hw, cin) in ((RES, 128), (RES // 8, 512)):
                backend.reset_launch_counts()
                same = {
                    "group_stats": _same_twice(
                        lambda: group_stats(xd, GROUPS)),
                    "group_norm_affine": _same_twice(new),
                    "group_norm_silu": _same_twice(
                        lambda: group_norm_silu(xd, gs, gb,
                                                num_groups=GROUPS))}
                counts = backend.launch_counts()
                log(f"  {hw}^2 C={cin} {dname}: two launches bit-identical: "
                    f"{same}")
                assert all(same.values()) and counts["group_stats"] == 4 \
                    and counts["group_norm_silu"] == 2, (same, counts)
                repeats.append(f"{hw}^2 C={cin} {dname}")
            del xd
        del x
        torch.cuda.empty_cache()
    out = {}
    for dname, t in tot.items():
        b_ms, b_by = bound(t["nbytes"], 0.0)
        log(f"  stats pass per batch, {dname}: {t['ms']:.3f} ms, PR 1's "
            f"{t['pr1_ms']:.3f} ms; bound {b_ms:.3f} ms ({b_ms / t['ms']:.1%} "
            f"of it; PR 1 {b_ms / t['pr1_ms']:.1%}); plain "
            f"{t['plain_ms']:.3f}, torch.var_mean {t['library_ms']:.3f} ms")
        assert t["ms"] < t["pr1_ms"], (dname, t)
        out[dname] = dict(t, bound_ms=b_ms, bound_by=b_by)
    bf, f32 = out["bfloat16"], out["float32"]
    results["group_stats"].update(
        ms=bf["ms"], plain_ms=bf["plain_ms"], library_ms=bf["library_ms"],
        bound_ms=bf["bound_ms"], bound_by=bf["bound_by"], pr1_ms=bf["pr1_ms"],
        ms_fp32=f32["ms"], plain_ms_fp32=f32["plain_ms"],
        library_ms_fp32=f32["library_ms"], bound_ms_fp32=f32["bound_ms"],
        pr1_ms_fp32=f32["pr1_ms"], bit_identical_repeats=repeats, sites=rows,
        library="torch.var_mean over the groups (fp32 upcast)",
        per=f"{B_PER_FORWARD} launches: one batch of {BATCH} at {RES}px; "
            f"ms, plain_ms, library_ms and bound_ms bf16, *_fp32 fp32")


def device_breakdown():
    """Kernel A's device time by kernel (torch.profiler), in a process of
    its own: the stats pass at each stats site in bf16 and fp32, new and
    PR 1's on the same inputs, and A's two passes at its sites.  Returns
    {"stats": {"H C dtype": {"new": {kernel: ms}, "pr1": {...}}},
    "a": {dtype: {"kernel, silu=...": ms}}}."""
    import torch
    from vae_tagger_tpu_torch.ops.normalization import (
        group_norm_affine,
        group_norm_silu,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out = {"stats": {}, "a": {}}
    with torch.inference_mode():
        for hw, cin in _stats_shapes():
            x = torch.randn(BATCH, hw, hw, cin, device="cuda",
                            generator=g) + 0.3
            gs = torch.randn(cin, device="cuda", generator=g) * 0.2 + 1.0
            gb = torch.randn(cin, device="cuda", generator=g) * 0.1
            for dt in (torch.bfloat16, torch.float32):
                xd = x.to(dt)
                key = f"{hw} {cin} {str(dt).removeprefix('torch.')}"
                out["stats"][key] = {
                    "new": _device_ms_by_kernel(lambda: group_norm_affine(
                        xd, gs, gb, num_groups=GROUPS)),
                    "pr1": _device_ms_by_kernel(
                        lambda: _pr1_stats(xd, gs, gb))}
                del xd
            del x
            torch.cuda.empty_cache()
        x = torch.randn(BATCH, RES // 8, RES // 8, 512, device="cuda",
                        generator=g) + 0.5
        sc = torch.randn(512, device="cuda", generator=g) * 0.2 + 1.0
        bi = torch.randn(512, device="cuda", generator=g) * 0.1
        for dt in (torch.bfloat16, torch.float32):
            xd, dev = x.to(dt), {}
            for silu in (False, True):
                for k, v in _device_ms_by_kernel(lambda: group_norm_silu(
                        xd, sc, bi, num_groups=GROUPS,
                        apply_silu=silu)).items():
                    dev[f"{k}, silu={silu}"] = v
            out["a"][str(dt).removeprefix("torch.")] = dev
    return out


def phase_device_breakdown(results):
    """Device time by kernel of kernel A's stats pass at each stats site
    (the rows of phase_stats_sites), new and PR 1's, with their achieved
    bandwidth beside the timing loop's ms, and of A's two passes: measured
    by ``device_breakdown`` in a child process, since a profiler session
    may slow the host's launches after it, and profiles taken after the
    train step's gave partial counts."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--device-breakdown"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    if proc.returncode:
        raise RuntimeError(f"device breakdown failed:\n{proc.stderr[-4000:]}")
    data = json.loads(proc.stdout.strip().splitlines()[-1])
    log("kernel A, device ms by kernel (torch.profiler, a child process): "
        "the stats pass at each stats site (batch 4), new and PR 1's, GB/s "
        "and share of the bytes bound, beside the timing loop's ms; A's two "
        "passes")
    st = results["group_stats"]
    tot = {}
    for row in st["sites"]:
        said = []
        for key in ("new", "pr1"):
            dev = data["stats"][f"{row['hw']} {row['c']} {row['dtype']}"][key]
            total = sum(dev.values())
            row[f"{key}_device"] = dict(by_kernel=dev, ms=total,
                                        gb_per_s=row["bytes"] / total / 1e6)
            t = tot.setdefault(row["dtype"], {"new": 0.0, "pr1": 0.0})
            t[key] += row["sites"] * total
            said.append(
                f"{key} " + " + ".join(f"{k} {v:.4f}" for k, v in dev.items())
                + f" = {total:.4f} ms ({row['bytes'] / total / 1e6:.0f} GB/s, "
                f"{row['bound_ms'] / total:.0%} of bound), loop "
                f"{row['ms' if key == 'new' else 'pr1_ms']:.4f}")
        log(f"  {row['hw']}^2 C={row['c']} {row['dtype']} x{row['sites']}: "
            f"{'; '.join(said)}")
    for dname, t in tot.items():
        sfx = "" if dname == "bfloat16" else "_fp32"
        b_ms = st[f"bound_ms{sfx}"]
        log(f"  stats pass per batch, {dname}: {t['new']:.3f} ms device "
            f"({b_ms / t['new']:.1%} of bound), PR 1's {t['pr1']:.3f}")
        st[f"device_ms{sfx}"], st[f"pr1_device_ms{sfx}"] = t["new"], t["pr1"]
    a = results["group_norm_silu"]
    for dname, dev in data["a"].items():
        a[f"device_ms_by_kernel{'' if dname == 'bfloat16' else '_fp32'}"] = dev
        log(f"  A ({BATCH}, {RES // 8}, {RES // 8}, 512) {dname}, one call "
            f"each: " + ", ".join(f"{k} {v:.4f}" for k, v in dev.items())
            + " ms")


def _simt_fwd(q, k, v):
    """Kernel C (SIMT, fp32) launched directly on fp32 tensors, which the
    port sends to C'': the yardstick C'' must beat on the same inputs."""
    import torch
    from vae_tagger_tpu_torch.ops import _build

    b, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, sq, device=q.device)
    _build.check(_build.lib("flash_attention_fwd").vt_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), 0, b, sq, k.shape[1], d,
        1.0 / d ** 0.5, out.data_ptr(), lse.data_ptr(), _build.stream_of(q)),
        "vt_flash_attn_fwd")
    return out, lse


@contextlib.contextmanager
def _simt_fp32_forward():
    """Inside: fp32 CUDA tensors go to the SIMT kernels B and C in place of
    B'' and C'' (counted as ``gn_silu_conv3x3`` and ``flash_attention_fwd``),
    the fp32 path as the port ran it before them; bf16 is untouched.  A
    yardstick for the steady fp32 classify rate, measured in the same run."""
    import torch
    from vae_tagger_tpu_torch.ops import attention, conv

    conv_kernel, fwd_kernel = (conv._gn_silu_conv3x3_kernel,
                               attention._flash_attention_fwd_kernel)

    def simt_conv_kernel(x, gs, gb, kern, bias, res, sck, scb, num_groups,
                         eps):
        if x.dtype != torch.float32:
            return conv_kernel(x, gs, gb, kern, bias, res, sck, scb,
                               num_groups, eps)
        res = None if res is None else res.float().contiguous()
        return _simt_conv(x.contiguous(), gs, gb, kern.float(), bias.float(),
                          res, None if sck is None else sck.float(),
                          None if scb is None else scb.float(), num_groups,
                          eps), "gn_silu_conv3x3"

    def simt_fwd_kernel(q, k, v):
        if q.dtype != torch.float32:
            return fwd_kernel(q, k, v)
        return (*_simt_fwd(q.contiguous(), k.contiguous(), v.contiguous()),
                "flash_attention_fwd")

    conv._gn_silu_conv3x3_kernel = simt_conv_kernel
    attention._flash_attention_fwd_kernel = simt_fwd_kernel
    try:
        yield
    finally:
        conv._gn_silu_conv3x3_kernel = conv_kernel
        attention._flash_attention_fwd_kernel = fwd_kernel


def _bwd_fp64(q, k, v, do, lse, delta):
    """(dq, dk, dv) of the attention backward computed in fp64 from the
    same inputs, the same L and the same Dl, one batch element at a time:
    the reference against which D'' and E'' and the SIMT D and E are both
    held."""
    import torch

    scale = 1.0 / q.shape[-1] ** 0.5
    outs = []
    for i in range(q.shape[0]):
        qq, kk, vv, dd = (t[i].double() for t in (q, k, v, do))
        p = torch.exp(qq @ kk.T * scale - lse[i].double()[:, None])
        ds = p * (dd @ vv.T - delta[i].double()[:, None])
        outs.append((ds @ kk * scale, ds.T @ qq * scale, p.T @ dd))
        del p, ds
    return tuple(torch.stack([o[j] for o in outs]) for j in range(3))


def _simt_part(part, keep, args):
    """Kernel D (``part`` "dq") or E ("dkv") launched directly in the
    inputs' dtype, on the checked arguments of ``attention._bwd_args``
    (kept tensors, C arguments); returns its outputs."""
    from vae_tagger_tpu_torch.ops import _build

    simt, st = _build.lib("flash_attention_bwd"), _build.stream_of(keep[0])
    if part == "dq":
        dq = keep[0].new_empty(keep[0].shape)
        _build.check(simt.vt_flash_attn_bwd_dq(*args, dq.data_ptr(), st),
                     "vt_flash_attn_bwd_dq")
        return (dq,)
    dk, dv = (t.new_empty(t.shape) for t in keep[1:3])
    _build.check(simt.vt_flash_attn_bwd_dkv(*args, dk.data_ptr(),
                                            dv.data_ptr(), st),
                 "vt_flash_attn_bwd_dkv")
    return dk, dv


def _simt_bwd(q, k, v, do, lse, delta):
    """Kernels D and E launched directly in q's dtype: on fp32 tensors,
    which the port sends to D'' and E'', and on bf16 tensors (D' and E'),
    they are the yardstick the tensor-core kernels must beat on the same
    inputs."""
    from vae_tagger_tpu_torch.ops import attention

    keep, args = attention._bwd_args(q, k, v, do, lse, delta)
    return _simt_part("dq", keep, args) + _simt_part("dkv", keep, args)


@contextlib.contextmanager
def _simt_fp32_backward():
    """Inside: the fp32 attention backward runs the SIMT kernels D and E in
    place of D'' and E'' (counted as ``flash_attention_bwd_dq`` and
    ``flash_attention_bwd_dkv``), the fp32 backward as the port ran it
    before them; bf16 is untouched.  A yardstick for the steady fp32 train
    step, measured in the same run."""
    import torch
    from vae_tagger_tpu_torch.ops import attention, backend

    bwd_kernel = attention._bwd_kernel

    def simt_bwd_kernel(part, q, k, v, do, lse, delta):
        if q.dtype != torch.float32:
            return bwd_kernel(part, q, k, v, do, lse, delta)
        outs = _simt_part(part, *attention._bwd_args(q, k, v, do, lse,
                                                     delta))
        backend.count_launch(f"flash_attention_bwd_{part}")
        return outs

    attention._bwd_kernel = simt_bwd_kernel
    try:
        yield
    finally:
        attention._bwd_kernel = bwd_kernel


def phase_kernel_de(g, results):
    import torch
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.attention import (
        _bwd_args,
        bwd_delta,
        bwd_tc_kernel_attrs,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )

    log(f"kernels D' and E' (bf16) and D'' and E'' (fp32): the "
        f"flash-attention backward, one head, D=512, B={TRAIN_ROWS} (one "
        f"train step at batch 1); the SIMT kernels D and E on the same fp32 "
        f"inputs")
    d, b, full = 512, TRAIN_ROWS, (RES // 8) ** 2
    parts = {"dq": flash_attention_bwd_dq, "dkv": flash_attention_bwd_dkv}
    # kernel -> (its part of the backward, the dtype it runs)
    kinds = {"flash_attention_bwd_dq_tc": ("dq", torch.bfloat16),
             "flash_attention_bwd_dkv_tc": ("dkv", torch.bfloat16),
             "flash_attention_bwd_dq_tf32x3": ("dq", torch.float32),
             "flash_attention_bwd_dkv_tf32x3": ("dkv", torch.float32)}
    chk = {name: Check(name, ("bf16",) if dt == torch.bfloat16 else ("fp32",))
           for name, (_, dt) in kinds.items()}
    attrs = {dt: bwd_tc_kernel_attrs(dt)
             for dt in (torch.bfloat16, torch.float32)}
    log(f"  D' and E' (cudaFuncGetAttributes): {attrs[torch.bfloat16]}")
    log(f"  D'' and E'' (cudaFuncGetAttributes): {attrs[torch.float32]}")
    timed, repeats, simt_errs = {}, {}, {"dq": {}, "dkv": {}}
    for s in ((RES // 16) ** 2, full):
        q, k, v, do = (_rnd(g, b, s, d) for _ in range(4))
        with backend.backend("torch"):
            o, lse = flash_attention_fwd(q, k, v)
        delta = bwd_delta(o, do)
        ins = {dt: tuple(t.to(dt) for t in (q, k, v, do))
               for dt in (torch.float32, torch.bfloat16)}
        f32 = ins[torch.float32]

        def call(name, dt=None):
            part, own = kinds[name]
            out = parts[part](*ins[dt or own], lse, delta)
            return out if isinstance(out, tuple) else (out,)

        label = f"B={b} S={s}"
        refs = {}
        for name, (part, dt) in kinds.items():
            ref = chk[name].run(label, lambda dt, name=name: call(name, dt))
            if dt == torch.float32:
                refs[part] = ref
        # the SIMT D and E on the same fp32 inputs: D'' and E'' must not be
        # less accurate than 4x theirs, both measured against the function
        # in fp64 on the same inputs.  (Against the plain fp32 version the
        # SIMT kernels look more accurate than they are: they round their
        # fp32 intermediates S, P and dP as it does, and so share its own
        # error, about 1e-6 at these shapes; both numbers are reported.)
        ref64 = _bwd_fp64(*f32, lse, delta)
        simt = _simt_bwd(*f32, lse, delta)
        for part, sl in (("dq", slice(0, 1)), ("dkv", slice(1, 3))):
            name = f"flash_attention_bwd_{part}_tf32x3"
            new = call(name)
            err = {
                "new": max(r["rel_err_fp32"]
                           for r in chk[name].rows[-len(new):]),
                "simt": max(rel_err(o_, r)
                            for o_, r in zip(simt[sl], refs[part])),
                "new64": max(rel_err(o_, r) for o_, r in zip(new, ref64[sl])),
                "simt64": max(rel_err(o_, r)
                              for o_, r in zip(simt[sl], ref64[sl])),
                "plain64": max(rel_err(o_, r)
                               for o_, r in zip(refs[part], ref64[sl]))}
            log(f"  {name} {label}: against the plain fp32 version "
                f"{err['new']:.3e}, the SIMT kernel "
                f"{'D' if part == 'dq' else 'E'}'s {err['simt']:.3e}; "
                f"against fp64 {err['new64']:.3e}, the SIMT kernel's "
                f"{err['simt64']:.3e} (gate 4x), the plain fp32 version's "
                f"{err['plain64']:.3e}")
            assert err["new64"] <= 4 * err["simt64"], (name, label, err)
            for key, val in err.items():
                simt_errs[part].setdefault(key, []).append(val)
            del new
        del simt, refs, ref64
        # no float atomics: a second launch repeats the first bit for bit
        for name in kinds:
            first, second = call(name), call(name)
            same = all(torch.equal(x, y) for x, y in zip(first, second))
            log(f"  {name} {label}: two launches bit-identical: {same}")
            assert same, f"{name}: two launches differ"
            repeats.setdefault(name, []).append(f"S={s}")
            del first, second
        if s == full:
            for name in kinds:
                fn = lambda name=name: call(name)  # noqa: E731
                timed[name] = {"ms": time_ms(fn)}
                with backend.backend("torch"):
                    timed[name]["plain_ms"] = time_ms(fn)
            bf = ins[torch.bfloat16]
            simt_bf16_ms = time_ms(lambda: _simt_bwd(*bf, lse, delta),
                                   max_iters=5)
            # the SIMT D and E apart, on the fp32 inputs
            keep, args = _bwd_args(*f32, lse, delta)
            simt_ms = {p_: time_ms(lambda p_=p_: _simt_part(p_, keep, args),
                                   max_iters=3) for p_ in ("dq", "dkv")}
            del keep, args
            lib_ms = {}
            for dt in (torch.bfloat16, torch.float32):
                with torch.enable_grad():
                    qb, kb, vb = (t.detach().requires_grad_()
                                  for t in ins[dt][:3])
                    out = sdpa(qb, kb, vb)
                    dob = ins[dt][3][:, None]
                    lib_ms[dt] = time_ms(lambda: torch.autograd.grad(
                        out, (qb, kb, vb), dob, retain_graph=True))
                    del out, qb, kb, vb
            tc_ms = (timed["flash_attention_bwd_dq_tc"]["ms"]
                     + timed["flash_attention_bwd_dkv_tc"]["ms"])
            log(f"  on the same bf16 inputs: D' + E' {tc_ms:.3f} ms, D + E "
                f"{simt_bf16_ms:.3f} ms, SDPA's backward "
                f"{lib_ms[torch.bfloat16]:.3f} ms")
            assert tc_ms < simt_bf16_ms, (tc_ms, simt_bf16_ms)
            x3_ms = (timed["flash_attention_bwd_dq_tf32x3"]["ms"]
                     + timed["flash_attention_bwd_dkv_tf32x3"]["ms"])
            simt32_ms = simt_ms["dq"] + simt_ms["dkv"]
            log(f"  on the same fp32 inputs: D'' + E'' {x3_ms:.3f} ms "
                f"(D'' {timed['flash_attention_bwd_dq_tf32x3']['ms']:.3f}, "
                f"E'' {timed['flash_attention_bwd_dkv_tf32x3']['ms']:.3f}), "
                f"D + E {simt32_ms:.3f} ms (D {simt_ms['dq']:.3f}, E "
                f"{simt_ms['dkv']:.3f}), SDPA's fp32 backward "
                f"{lib_ms[torch.float32]:.3f} ms")
            assert x3_ms < simt32_ms, (x3_ms, simt32_ms)
            for name, (part, dt) in kinds.items():
                esize = 2.0 if dt == torch.bfloat16 else 4.0
                # q k v dO read, L and Dl read, dq or dk and dv written
                nbytes = (esize * 4 * b * s * d + 4.0 * 2 * b * s
                          + esize * (1 if part == "dq" else 2) * b * s * d)
                flops = (6.0 if part == "dq" else 8.0) * b * s * s * d
                if dt == torch.bfloat16:
                    b_ms, b_by = bound(nbytes, flops)
                else:
                    (c_ms, c_by), (b_ms, b_by) = _fp32_bounds(nbytes, flops)
                    timed[name].update(bound_ms_cuda_cores=c_ms,
                                       bound_by_cuda_cores=c_by,
                                       simt_ms=simt_ms[part])
                    log(f"  {name}: {timed[name]['ms']:.3f} ms, bound "
                        f"{b_ms:.3f} ms as 3xTF32 "
                        f"({b_ms / timed[name]['ms']:.1%}), {c_ms:.3f} ms on "
                        f"the CUDA cores")
                timed[name].update(library_ms=lib_ms[dt], bound_ms=b_ms,
                                   bound_by=b_by, flops=flops)
            # E' and E'' compute S^T in both passes: 10 B S^2 D of their own
            own = 10.0 * b * s * s * d
            for name, dname in (("flash_attention_bwd_dkv_tc", "bfloat16"),
                                ("flash_attention_bwd_dkv_tf32x3",
                                 "tf32x3")):
                esize = 2.0 if dname == "bfloat16" else 4.0
                timed[name].update(
                    kernel_flops=own, bound_ms_kernel_flops=bound(
                        esize * 6 * b * s * d + 8.0 * b * s, own, dname)[0])
            for name in ("flash_attention_bwd_dq_tc",
                         "flash_attention_bwd_dkv_tc"):
                timed[name]["simt_on_bf16_ms_dq_plus_dkv"] = simt_bf16_ms
                timed[name]["tc_ms_dq_plus_dkv"] = tc_ms
            for name in ("flash_attention_bwd_dq_tf32x3",
                         "flash_attention_bwd_dkv_tf32x3"):
                timed[name]["simt_ms_dq_plus_dkv"] = simt32_ms
                timed[name]["tf32x3_ms_dq_plus_dkv"] = x3_ms
        del q, k, v, do, o, lse, delta, ins, f32
        torch.cuda.empty_cache()
    for name, (part, dt) in kinds.items():
        tc = dt == torch.bfloat16
        results[name] = dict(
            chk[name].summary(), **timed[name],
            library=f"backward of {SDPA_NAME} (dq, dk and dv in one "
                    f"call), {'bf16' if tc else 'fp32'}",
            runtime_attrs=attrs[dt], bit_identical_repeats=repeats[name],
            per=f"{2 if part == 'dkv' else 1} launch(es): one train step at "
                f"batch 1, {RES}px (B={TRAIN_ROWS} stacked, S={full}), "
                f"{'bf16' if tc else 'fp32'}")
        if not tc:
            errs = {key: max(vals) for key, vals in simt_errs[part].items()}
            results[name].update(
                simt_max_rel_err_fp32=errs["simt"],
                max_rel_err_fp64=errs["new64"],
                simt_max_rel_err_fp64=errs["simt64"],
                plain_max_rel_err_fp64=errs["plain64"])


def phase_autograd(g):
    import torch
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.attention import flash_attention
    from vae_tagger_tpu_torch.ops.conv import gn_silu_conv3x3
    from vae_tagger_tpu_torch.ops.normalization import group_norm_silu

    log("autograd on the card: A, B'' and C'' carry gradients; kernel path vs "
        "torch backend in fp32 (relative error <= 1e-4); the bf16 attention "
        "gradients (C', D', E') within 4x the plain bf16 path's error")

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
    # the bf16 attention (C', D', E') at the mid-block shape: gradients
    # against the plain fp32 path within 4x the plain bf16 path's own error
    gq = _rnd(g, *q.shape)

    def attn_grads(dt, be):
        ins = [t.detach().to(dt).requires_grad_() for t in (q, k, v)]
        with backend.backend(be):
            return torch.autograd.grad(flash_attention(*ins), ins, gq.to(dt))

    backend.reset_launch_counts()
    got = attn_grads(torch.bfloat16, "kernel")
    torch.cuda.synchronize()
    launched = {k: n for k, n in backend.launch_counts().items() if n}
    want = {"flash_attention_fwd_tc": 1, "flash_attention_bwd_dq_tc": 1,
            "flash_attention_bwd_dkv_tc": 2}
    assert launched == want, launched
    ref = attn_grads(torch.float32, "torch")
    plain = attn_grads(torch.bfloat16, "torch")

    def norm_err(a, r):
        return ((a.float() - r).norm() / r.norm()).item()

    errs = [norm_err(a, r) for a, r in zip(got, ref)]
    owns = [norm_err(p, r) for p, r in zip(plain, ref)]
    log(f"  flash_attention bf16 (B={TRAIN_ROWS}, S={q.shape[1]}): launches "
        f"{launched}, gradient rel errors vs fp32 plain "
        f"{', '.join(f'{e:.2e}' for e in errs)}; plain bf16's own "
        f"{', '.join(f'{e:.2e}' for e in owns)} (gate 4x)")
    assert all(e <= 4 * o for e, o in zip(errs, owns)), (errs, owns)
    out["flash_attention_bf16"] = dict(launches=launched, rel_errs=errs,
                                       plain_bf16_rel_errs=owns)
    return out


def _expected(per_batch, n):
    """Every launch counter's exact expected count after n batches: those
    of ``per_batch`` times n, every other kernel 0."""
    from vae_tagger_tpu_torch.ops import backend

    return {k: n * per_batch.get(k, 0) for k in backend.launch_counts()}


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
        f"{RES}px PNGs, batch {BATCH}, through the infer CLI in bf16 and at "
        f"its default precision (fp32)")
    t0 = time.perf_counter()
    art = _write_artifacts()
    log(f"  artifacts written in {time.perf_counter() - t0:.1f} s")
    paths = [str(p) for p in get_image_paths(art["images"])]
    n_batches = -(-N_IMAGES // BATCH)

    def cli(precision):
        """One run of the infer CLI (``precision`` None: no
        --mixed_precision flag, the CLI's default, fp32) with the launch
        counts reset just before it and read just after; checks the
        results JSON and the exact launches of every batch."""
        out_dir = f"{art['out']}_{precision or 'default'}"
        argv = ["--vae_checkpoint", art["vae"], "--vae_config_path",
                art["config"], "--decoder_checkpoint", art["decoder"],
                "--image_path", art["images"], "--tags_csv_path",
                art["tags"], "--output_dir", out_dir, "--resolution",
                str(RES), "--batch_size", str(BATCH), "--num_workers", "4"]
        if precision is not None:
            argv += ["--mixed_precision", precision]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        out = infer_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = backend.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        name = precision or "default (fp32)"
        log(f"  CLI, {name}: {len(out)} images in {wall:.2f} s (load + "
            f"decode + {n_batches} batches), peak device memory "
            f"{peak / 2**30:.2f} GiB")
        log(f"  launches in the main path, {name}: {counts}")
        with open(Path(out_dir) / "classification_results.json") as f:
            on_disk = json.load(f)
        assert sorted(on_disk) == sorted(paths) and len(paths) == N_IMAGES, \
            "results JSON misses images"
        for r in on_disk.values():
            for key in ("max_confidence", "avg_confidence_top5"):
                assert np.isfinite(r[key]), r
        expect = _expected(ENCODE_LAUNCHES[precision or "fp32"], n_batches)
        for k, want in expect.items():
            assert counts[k] == want, (name, k, counts[k], want)
        return out, wall, counts, peak, expect

    out, wall, counts, peak, expect = cli("bf16")
    out32, wall32, counts_cli32, peak32, expect_cli32 = cli(None)

    # steady-state classify and the fp32 latent gate on one batch
    batch = next(iter(iter_image_batches(paths, RES, BATCH, 4, 1)))[2]
    kw = dict(vae_checkpoint=art["vae"], decoder_checkpoint=art["decoder"],
              tags_csv_path=art["tags"], vae_config_path=art["config"])
    eng16 = TaggerEngine.load(mixed_precision="bf16", **kw)
    probs = eng16.classify(batch)
    assert probs.shape == (BATCH, art["num_tags"]) and np.isfinite(probs).all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = 50  # about 3 s at 60 ms a batch
    for _ in range(iters):
        eng16.classify(batch)
    steady = iters * BATCH / (time.perf_counter() - t0)
    log(f"  steady-state classify, bf16: {steady:.3f} images/s "
        f"(host clock, {iters} batches of {BATCH}, host->device copy included)")
    lat16 = eng16.encode(batch)
    with backend.backend("torch"):
        lat16_t = eng16.encode(batch)
    del eng16
    # the fp32 path, one batch through the engine: kernels B'' and C''; its
    # steady classify rate, then the fp32 latent gate
    eng32 = TaggerEngine.load(mixed_precision="no", **kw)
    eng32.classify(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters32 = 10  # about 2.5 s at 0.25 s a batch
    for _ in range(iters32):
        eng32.classify(batch)
    steady32 = iters32 * BATCH / (time.perf_counter() - t0)
    log(f"  steady-state classify, fp32 (the CLI's default): {steady32:.3f} "
        f"images/s (host clock, {iters32} batches of {BATCH}); bf16: "
        f"{steady:.3f} images/s")
    # the same with the SIMT B and C in place of B'' and C'': the fp32 path
    # as the port ran it before them, on this card in this run
    iters_simt = 5  # about 7 s at 1.3 s a batch
    with _simt_fp32_forward():
        eng32.classify(batch)
        torch.cuda.synchronize()
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(iters_simt):
            eng32.classify(batch)
        steady32_simt = iters_simt * BATCH / (time.perf_counter() - t0)
        counts_simt = backend.launch_counts()
    want = _expected({"gn_silu_conv3x3": 20, "flash_attention_fwd": 1,
                      "group_norm_silu": 2, "group_stats": 20}, iters_simt)
    assert all(counts_simt[k] == n for k, n in want.items()), counts_simt
    log(f"  steady-state classify, fp32 with the SIMT B and C: "
        f"{steady32_simt:.3f} images/s (host clock, {iters_simt} batches)")
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    lat_k = eng32.encode(batch)
    torch.cuda.synchronize()
    counts32 = backend.launch_counts()
    log(f"  launches in the fp32 path (one batch through TaggerEngine): "
        f"{counts32}")
    expect32 = _expected(ENCODE_LAUNCHES["fp32"], 1)
    for name, want in expect32.items():
        assert counts32[name] == want, (name, counts32[name], want)
    with backend.backend("torch"):
        lat_t = eng32.encode(batch)
    mse = float(np.mean((lat_k - lat_t) ** 2))
    mse16 = float(np.mean((lat16 - lat_t) ** 2))
    mse16_t = float(np.mean((lat16_t - lat_t) ** 2))
    log(f"  fp32 latents, kernel path vs torch path: MSE {mse:.3e} "
        f"(gate 1e-10; BASELINE.json's latent gate is 1e-4)")
    log(f"  bf16 latents vs the fp32 torch path: kernel path MSE "
        f"{mse16:.3e}, torch backend's own bf16 MSE {mse16_t:.3e} (gate: "
        f"kernel <= 4x torch, {4 * mse16_t:.3e})")
    assert np.isfinite(lat_k).all() and mse < 1e-10, mse
    assert np.isfinite(lat16).all() and mse16 <= 4 * mse16_t, \
        (mse16, mse16_t)
    # one fp32 batch with PyTorch's default for cuDNN (TF32 on), as a
    # user's process has it: the convs outside B'' (conv_in, the
    # downsamples, conv_out, quant_conv, the head's) then run in TF32.
    # Its latents against the TF32-off plain path, and its steady rate.
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        eng32.classify(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters32):
            eng32.classify(batch)
        steady32_tf32 = iters32 * BATCH / (time.perf_counter() - t0)
        lat_tf32 = eng32.encode(batch)
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    mse_tf32 = float(np.mean((lat_tf32 - lat_t) ** 2))
    log(f"  fp32 with PyTorch's default cuDNN TF32 on: latent MSE "
        f"{mse_tf32:.3e} against the TF32-off torch path (BASELINE.json's "
        f"latent gate 1e-4); steady classify {steady32_tf32:.3f} images/s "
        f"(host clock, {iters32} batches; TF32 off: {steady32:.3f})")
    assert np.isfinite(lat_tf32).all() and mse_tf32 < 1e-4, mse_tf32
    del eng32
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    return dict(images=len(out), cli_wall_s=wall,
                cli_images_per_s=len(out) / wall,
                steady_images_per_s_bf16=steady, peak_mem_bytes=peak,
                launches=counts, expected_launches=expect,
                cli_fp32=dict(images=len(out32), wall_s=wall32,
                              images_per_s=len(out32) / wall32,
                              peak_mem_bytes=peak32),
                launches_cli_fp32=counts_cli32,
                expected_launches_cli_fp32=expect_cli32,
                steady_images_per_s_fp32=steady32,
                steady_images_per_s_fp32_simt=steady32_simt,
                steady_images_per_s_fp32_cudnn_tf32=steady32_tf32,
                latent_mse_fp32_cudnn_tf32_vs_torch=mse_tf32,
                launches_fp32=counts32, expected_launches_fp32=expect32,
                latent_mse_fp32_kernel_vs_torch=mse,
                latent_mse_bf16_torch_vs_fp32_torch=mse16_t,
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
             "conv3x3_tc_kernel": "gn_silu_conv3x3_tc",
             "conv3x3_tf32x3_kernel": "gn_silu_conv3x3_tf32x3",
             "flash_fwd_tc_kernel": "flash_attention_fwd_tc",
             "flash_fwd_tf32x3_kernel": "flash_attention_fwd_tf32x3",
             "gn_stats_vec_kernel": "group_stats (+A's stats)",
             "gn_apply_vec_kernel": "group_norm_silu (apply)",
             "flash_fwd_kernel": "flash_attention_fwd",
             "flash_bwd_dq_kernel": "flash_attention_bwd_dq",
             "flash_bwd_dkv_kernel": "flash_attention_bwd_dkv",
             "flash_bwd_dq_tc_kernel": "flash_attention_bwd_dq_tc",
             "flash_bwd_dv_tc_kernel": "flash_attention_bwd_dkv_tc (dV pass)",
             "flash_bwd_dk_tc_kernel": "flash_attention_bwd_dkv_tc (dK pass)",
             "flash_bwd_tf32x3_kernel<0>": "flash_attention_bwd_dq_tf32x3",
             "flash_bwd_tf32x3_kernel<1>":
                 "flash_attention_bwd_dkv_tf32x3 (dK pass)",
             "flash_bwd_tf32x3_kernel<2>":
                 "flash_attention_bwd_dkv_tf32x3 (dV pass)"}
    # a name that is part of another would take its time
    assert not [a for a in names for b_ in names if a != b_ and a in b_]
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
        backend.reset_launch_counts()
        with backend.backend(be):
            total, _, _ = steps.forward_losses(
                state, dev_batch, step_generator(dev, SEED, 7), train=False)
            total.backward()
        torch.cuda.synchronize()
        if be == "kernel":  # A, stats, B'', C'', D'' and E'', exactly
            launches = backend.launch_counts()
            expect = _expected(GATE_LAUNCHES, 1)
            log(f"  launches in the gate's kernel path: "
                f"{ {k: n for k, n in launches.items() if n} }")
            assert launches == expect, (launches, expect)
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
    return dict(parameters=len(params), launches=launches,
                expected_launches=expect, worst_param=worst[0],
                worst_err=worst[1], worst_param_grad_norm=worst[2],
                median_err=sorted(errs)[len(errs) // 2], losses=losses,
                compared_absolutely={k: dict(torch_norm=a, diff_norm=b)
                                     for k, (a, b) in absolute.items()},
                smallest_relative_norm=min(norms))


def _train_cli(art, json_path, extra, precision):
    """One epoch of ``python -m vae_tagger_tpu_torch.train.train_full``'s
    entry point at ``--mixed_precision precision`` ("bf16" or "no"), with
    the launch counts reset just before it and read just after.  Checks the
    exact launches, finite losses, every encoder and head parameter
    changed, and the VAE decoder tensor kept by the export.  Returns the
    trained state, the output directory and a report."""
    import numpy as np
    import torch
    from safetensors.torch import load_file
    from vae_tagger_tpu_torch.data.loader import train_val_split
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.train.train_full import main as train_main

    key = "bf16" if precision == "bf16" else "fp32"
    out = WORK / f"train_out_{key}"
    argv = ["--json_path", json_path, "--tags_csv_path", art["tags"],
            "--vae_checkpoint", art["vae"], "--vae_config_path",
            art["config"], "--decoder_checkpoint", art["decoder"],
            "--output_dir", str(out), "--resolution", str(RES),
            "--train_batch_size", "1", "--num_epochs", "1",
            "--mixed_precision", precision, "--lr_warmup_steps", "0",
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
    log(f"  CLI, {key}: {n_train} train steps + {n_val} validation batch in "
        f"{wall:.2f} s (load, exports and checkpoints included), peak "
        f"device memory {cli_peak / 2**30:.2f} GiB")
    log(f"  launches in the training path, {key}: {counts}")
    expect = {k: n_train * TRAIN_STEP_LAUNCHES[key].get(k, 0)
              + n_val * ENCODE_LAUNCHES[key].get(k, 0) for k in counts}
    for name, want in expect.items():
        assert counts[name] == want, (key, name, counts[name], want)

    history = json.loads((out / "training_history.json").read_text())
    values = (history["train_loss"] + history["val_loss"]
              + [v for vs in history["train_metrics"].values() for v in vs])
    assert values and all(np.isfinite(values)), history
    log(f"  losses, {key}: train {history['train_loss']}, val "
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
    log(f"  parameters changed, {key}: encoder {len(enc) - len(same_vae)}/"
        f"{len(enc)}, head {len(head_params) - len(same_head)}/"
        f"{len(head_params)}")
    assert not same_vae and not same_head, (same_vae[:5], same_head[:5])
    assert torch.equal(after_vae["decoder.conv_in.weight"], extra), \
        "the export lost the VAE decoder tensor"
    return state, out, dict(train_steps=n_train, val_batches=n_val,
                            cli_wall_s=wall, cli_peak_mem_bytes=cli_peak,
                            launches=counts, expected_launches=expect,
                            history=history)


def _steady_step(state, batch, dtype, iters, first_index):
    """Mean host-clock time of ``iters`` train steps on one batch after one
    warm-up step, and the peak device memory over them."""
    import torch
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.train.steps import FullSteps

    steps = FullSteps(LossConfig(triplet_weight=1.0, use_focal_loss=False),
                      compute_dtype=dtype, seed=SEED)
    steps.train_step(state, batch, first_index)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(iters):
        steps.train_step(state, batch, first_index + 1 + i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters, \
        torch.cuda.max_memory_allocated(), steps


def _profiled_step(steps, state, batch, index):
    """Device time of one profiled train step, by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps.train_step(state, batch, index)
        torch.cuda.synchronize()
    by_kernel, top = _kernel_breakdown(prof)
    total_ms = sum(by_kernel.values())
    log(f"  one profiled step: {total_ms:.1f} ms of device time")
    for label, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        log(f"    {label}: {ms:.2f} ms")
    for ms, key in top:
        log(f"    top kernel {ms:.2f} ms: {key}")
    return total_ms, by_kernel, top


def phase_training():
    import numpy as np
    import torch
    from vae_tagger_tpu_torch.data.dataset import TaggedImageDataset
    from vae_tagger_tpu_torch.data.loader import DataLoader
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine
    from vae_tagger_tpu_torch.ops import backend

    log(f"training path: python -m vae_tagger_tpu_torch.train.train_full, "
        f"full FLUX VAE + attention head, {N_IMAGES} seeded {RES}px images "
        f"with {NUM_TAGS} tags, batch 1 (B={TRAIN_ROWS} stacked), bf16, then "
        f"fp32 (--mixed_precision no)")
    art = _write_artifacts(NUM_TAGS)
    json_path, extra = _write_training_data(art)
    state, out, rep16 = _train_cli(art, json_path, extra, "bf16")

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

    # steady bf16 step time on one batch, then one profiled step
    iters = 10
    step_s, peak, steps = _steady_step(state, batch, torch.bfloat16, iters,
                                       1000)
    log(f"  steady train step, bf16: {step_s * 1e3:.1f} ms, "
        f"{TRAIN_ROWS / step_s:.3f} images/s ({TRAIN_ROWS} per step; host "
        f"clock, {iters} steps), peak device memory {peak / 2**30:.2f} GiB")
    total_ms, by_kernel, top = _profiled_step(steps, state, batch, 2000)
    del state, steps
    torch.cuda.empty_cache()

    # fp32 (--mixed_precision no): D'' and E'' carry the attention backward
    state32, _, rep32 = _train_cli(art, json_path, extra, "no")
    iters32 = 4
    step32_s, peak32, steps32 = _steady_step(state32, batch, torch.float32,
                                             iters32, 3000)
    log(f"  steady train step, fp32: {step32_s * 1e3:.1f} ms, "
        f"{TRAIN_ROWS / step32_s:.3f} images/s (host clock, {iters32} "
        f"steps), peak device memory {peak32 / 2**30:.2f} GiB")
    total32_ms, by_kernel32, top32 = _profiled_step(steps32, state32, batch,
                                                    4000)
    # the same steady step with the SIMT D and E in place of D'' and E''
    iters_simt = 3
    with _simt_fp32_backward():
        steps32.train_step(state32, batch, 5000)
        torch.cuda.synchronize()
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(iters_simt):
            steps32.train_step(state32, batch, 5001 + i)
        torch.cuda.synchronize()
        step32_simt_s = (time.perf_counter() - t0) / iters_simt
        counts_simt = backend.launch_counts()
    want = dict(ENCODE_LAUNCHES["fp32"], flash_attention_bwd_dq=1,
                flash_attention_bwd_dkv=1)
    assert counts_simt == _expected(want, iters_simt), counts_simt
    log(f"  steady train step, fp32 with the SIMT D and E: "
        f"{step32_simt_s * 1e3:.1f} ms (host clock, {iters_simt} steps); "
        f"with D'' and E'': {step32_s * 1e3:.1f} ms")
    del state32, steps32
    torch.cuda.empty_cache()

    gate = _gradient_gate(art, batch)
    shutil.rmtree(WORK, ignore_errors=True)
    return dict(rep16, step_s_bf16=step_s,
                images_per_s_bf16=TRAIN_ROWS / step_s,
                step_peak_mem_bytes=peak, profiled_step_ms=total_ms,
                device_ms_by_kernel=by_kernel, top_kernels=top,
                fp32=dict(rep32, step_s=step32_s,
                          images_per_s=TRAIN_ROWS / step32_s,
                          step_peak_mem_bytes=peak32,
                          step_s_simt_d_e=step32_simt_s,
                          profiled_step_ms=total32_ms,
                          device_ms_by_kernel=by_kernel32,
                          top_kernels=top32),
                gradient_gate=gate)


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, default=None,
                        help="also write the full report to this JSON file")
    parser.add_argument("--device-breakdown", action="store_true",
                        help="only print kernel A's device time by kernel as "
                             "one JSON line (the child process of the last "
                             "phase)")
    args = parser.parse_args()
    if args.device_breakdown:
        print(json.dumps(device_breakdown()))
        return

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
        phase_stats_sites(g, results)
        torch.cuda.empty_cache()
        phase_kernel_c(g, results)
    torch.cuda.empty_cache()
    with torch.no_grad():
        phase_kernel_de(g, results)
    report["autograd"] = phase_autograd(g)
    torch.cuda.empty_cache()
    report["main_path"] = phase_main_path()
    report["training"] = phase_training()
    torch.cuda.empty_cache()
    phase_device_breakdown(results)
    report["kernels"] = results

    # launches: bf16 training runs A, its stats pass, B', C', D' and E';
    # the infer CLI at its default precision (fp32) runs A, stats, B'' and
    # C''; fp32 training and the fp32 gradient gate run those and D'' and
    # E''.  Each path's counts were reset just before it ran and read just
    # after.
    by_path = {"train_bf16": report["training"]["launches"],
               "train_fp32": report["training"]["fp32"]["launches"],
               "infer_bf16": report["main_path"]["launches"],
               "infer_fp32": report["main_path"]["launches_cli_fp32"],
               "infer_fp32_engine": report["main_path"]["launches_fp32"],
               "grad_gate_fp32":
                   report["training"]["gradient_gate"]["launches"]}
    kernels = []
    for name, meta in KERNELS.items():
        r = results[name]
        path = KERNEL_PATH.get(name, "train_bf16")
        launches = by_path[path][name]
        assert launches > 0, f"{name} was not launched on its path {path}"
        kernels.append(dict(
            name=name, **meta, launches=launches, path=path,
            launches_by_path={p: c[name] for p, c in by_path.items()},
            max_abs_err=r["max_abs_err"],
            max_rel_err_fp32=r["max_rel_err_fp32"],
            max_rel_err_bf16=r["max_rel_err_bf16"],
            plain_rel_err_bf16=r["plain_rel_err_bf16"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            per=r["per"],
            **({"predecessor": SIMT_PREDECESSOR[name],
                "predecessor_ms": r["simt_ms"],
                "predecessor_max_rel_err_fp32": r["simt_max_rel_err_fp32"],
                "bound_ms_cuda_cores": r["bound_ms_cuda_cores"]}
               if name in SIMT_PREDECESSOR else {}),
            **{k: r[k] for k in ("max_rel_err_fp64", "simt_max_rel_err_fp64",
                                 "plain_max_rel_err_fp64", "ms_fp32",
                                 "plain_ms_fp32", "library_ms_fp32",
                                 "bound_ms_fp32", "pr1_ms", "pr1_ms_fp32")
               if k in r}))
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
