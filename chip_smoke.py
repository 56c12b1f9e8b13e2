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
4. main path: the full FLUX VAE (block_out_channels (128, 256, 512, 512), 32
   groups, 16 latent channels) and the default attention head on seeded
   random weights, written in diffusers layout and as pytorch_model.bin,
   then ``python -m vae_tagger_tpu_torch.infer``'s entry point on seeded
   1024px PNGs at batch 4 in bf16.  Checks: every image in the JSON, finite
   probabilities, every kernel launched (A twice, B 20 times and C once per
   batch), and fp32 latents of the kernel path within MSE 1e-4 of the plain
   (torch-backend) path on the same batch;
5. one JSON line ``{"kernels": [...]}``, then as the last line
   ``{"ok": true, "device": {...}}``.

With ``--report PATH`` the full report is also written there as JSON.
"""

from __future__ import annotations

import json
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
}


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


def phase_build():
    from vae_tagger_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    wall = time.perf_counter() - t0
    log(f"build: {wall:.1f} s wall for {len(built)} sources (parallel nvcc)")
    for stem, rec in built.items():
        regs = [ln.strip() for ln in rec["log"].splitlines()
                if "registers" in ln]
        log(f"  {stem}: {rec['seconds']:.1f} s; {'; '.join(sorted(set(regs)))}")
    for stem in _build.SIGNATURES:
        _build.lib(stem)  # loads, raises if a library is missing
    return {"wall_s": wall,
            "sources": {k: v["seconds"] for k, v in built.items()}}


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
    report["main_path"] = phase_main_path()
    report["kernels"] = results

    launches = report["main_path"]["launches"]
    kernels = []
    for name, meta in KERNELS.items():
        r = results[name]
        kernels.append(dict(
            name=name, **meta, launches=launches[name],
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
