#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vae_tagger_tpu_torch) on one GPU.

    python3 chip_smoke.py [--report PATH] [--parent-tree DIR]

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
   D' + E' and D'' + E'' must beat them.  Kernel F, the GroupNorm(+SiLU)
   backward (``phase_kernel_f``), at the 22 GroupNorm sites of a train_full
   step (3 images at 1024px), the decoder's new sites and a spatial slab
   with given statistics: fp32 rel <= 1e-5 on every output, bf16 within 4x
   the plain bf16 version's error, two launches bit-identical, exactly its
   two kernels a call (torch.profiler); timed (timing loop and device
   time) beside its bytes bound, the plain version and the autograd of
   F.group_norm + F.silu;
4. autograd on the card: the outputs of A, B'' and C'' on tensors that require
   a gradient carry a ``grad_fn``, and each op's gradients through the
   kernel path (the GroupNorm and fused-conv sites' backward: A's apply
   pass, cuDNN's conv backward and kernel F) match the torch backend (the
   VJP of the plain version, recomputed) in fp32 (relative error <= 1e-4);
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
   22 (2 forward, 20 recomputing a fused conv's activation in the
   backward), stats 20, B' 20, C' 1, D' 1, E' 2, F 22; per fp32 step the
   same with B'', C'', D'', E''; every other kernel none; per validation batch
   the forward's, and of the final threshold search and evaluation one
   encode per validation batch), every encoder and head parameter
   changed, every VAE decoder tensor of the checkpoint exported unchanged
   (the simplified loss gives it no gradient), the final phase's files
   written; the bf16 exports
   classify through ``TaggerEngine``.  Then the steady step time (bf16 over
   10 steps, fp32 over 4), images/s and peak memory, a profiler breakdown
   of one step of each by kernel (the rest by name pattern: cuDNN's
   forward conv, dgrad and wgrad, cuBLAS, the optimizer, torch's
   elementwise; each call of kernel F's wrapper in a profiler range that
   must hold exactly F's two kernels), each again with the backward it
   replaced swapped in (the
   VJP of the plain version, recomputed: ``_recompute_backward``), and the
   count of cuDNN forward convolutions in a profiled step, which must equal
   the step's forward's alone (none for a fused site in the backward; the
   recompute's 20 more); the fp32 step again with the SIMT D and
   E in place of D'' and E'' (over 3 steps), and the gradient gate: on one
   fp32 batch, every parameter's gradient through the kernel path (A,
   stats, B'', C'', D'' and E'', with exact launch counts) within 1e-3 of
   the torch backend's, relative, or absolute where the torch path's norm
   is below 1e-8 (gradients that are zero in exact arithmetic);
7. the VAE decoder: kernel phases at the decoder's sites at
   batch 1 (``phase_decoder_kernels``: B' and B'' at its 28 fused convs,
   Cin > Cout and the shortcut from Cres > Cout among them, the stats pass
   at 512^2 C=512 and 1024^2 C=256, A at 1024^2 C=128, each against its
   plain version, timed beside it and the library call); the decode gate
   (one 1024px decode, fp32 kernel path vs plain MSE < 1e-10, bf16 within
   4x the plain bf16 path's own MSE, exact launches); ``python -m
   vae_tagger_tpu_torch.train.train_vae`` for one epoch in bf16 and in
   fp32 (exact launches per step: A 52, stats 48, B 48, C 2, D 2, E 4,
   F 52;
   finite losses; every encoder and decoder parameter changed; the bf16
   export reloads and decodes; steady step, images/s, peak memory, one
   profiled step by kernel each, before and after as train_full's) and
   the fp32 train_vae gradient gate over
   every parameter, the decoder's included (rel <= 1e-3); ``train_full
   --no_simplified_loss --use_adaptive_weights`` for one epoch in bf16
   (the adaptive weights move; the final phase writes
   optimal_thresholds.json and the evaluation files); ``python -m
   vae_tagger_tpu_torch.eval`` on its exports and ``python -m
   vae_tagger_tpu_torch.infer.latents`` on the 8 images, the latents
   against the engine's plain-path encode_scaled mode (MSE < 1e-10);
8. the tiled VAE, train_decoder and buckets, each phase fatal on any
   failed gate: ``phase_tile_bucket_kernels``: the kernels at the shapes the new paths give
   them, each against its plain version, timed beside it and the library
   call: B' and B'' at the decoder's 1024^2 256->128 conv and its shortcut
   from 256 channels at a tile batch of 8 (an input of 2^31 elements),
   the stats pass and A on that 2^31-element activation in both dtypes,
   B' and B'' at the 704x576 bucket (B=3, W != H), C', C'', D', E', D''
   and E'' at B=3, S=6,336, D=512 (no multiple of 128), and C' and C'' at
   B=8, S=16,384; ``phase_tiled``: ``TiledVAE`` on a seeded 2048x1536
   image (tile 1024, overlap 256: 6 tiles, one batch of 8), exact
   launches of a tile batch (encode A 2, stats 20, B 20, C 1; decode A 2,
   stats 28, B 28, C 1), fp32 kernel path vs plain path (latents and
   pixels MSE < 1e-10), bf16 within 4x the plain bf16 path's own MSE, one
   1024^2 tile vs ``VAEOnlyEngine.encode`` (MSE < 1e-10), wall time and
   peak memory, then the latents and reconstruction CLIs with
   ``--tiled``; ``phase_train_decoder``: ``python -m
   vae_tagger_tpu_torch.train.train_decoder`` for 2 epochs at batch 4 with
   ``--cache_latents`` in bf16, fp32, and yuv420 (exact launches: one
   encode a batch of epoch 1, none after; every head parameter changed,
   every VAE tensor as loaded; the final phase read the cache alone), the
   steady step with and without the cache; ``phase_buckets``: three
   seeded images in the buckets (704, 576), (768, 576) and (512, 512),
   ``train_full`` and ``train_vae --use_bucketing`` for one epoch in bf16
   and fp32 (``_train_cli``), the fp32 gradient gate on the 704x576
   triplet, the infer CLI with ``--transfer_format yuv420`` against RGB
   within YUV_PROB_BOUND, and ``yuv420_to_rgb_uint8`` on the card vs the
   CPU (<= 1 apart, >= 99.9% equal);
9. the HTTP server, the attention maps and the epoch loop's drills, each
   phase fatal on any failed gate: ``phase_serve``: ``TaggerServer`` at
   1024px, max_batch 8, fp32 then bf16, 16 concurrent clients posting 96
   seeded 2048x1536 images (JPEG q90 and PNG): every response 200 with
   the entry schema, every served probability vector within SERVE_TOL of
   ``engine.classify`` of the same pixels in another batch, exact
   launches per dispatched batch (A 2, stats 20, B 20, C 1); the rate,
   p50/p99 latency, batch-size histogram, the device's busy share, the
   rate at max_batch 1, the host's decode rate, ``os.cpu_count()`` and the
   native decode formats; a yuv420 server within YUV_PROB_BOUND of RGB;
   413, 400 and 503 provoked once each.  ``phase_attention_maps``:
   ``TaggerEngine.get_attention_maps`` at batch 4, fp32 and bf16, against
   the plain path, and the attention_viz CLI's files.
   ``phase_drills``: train_full in bf16 at 1024px: the preemption drill
   (``VAE_TAGGER_PREEMPT_AFTER_STEPS=2``), its mid-epoch resume for two
   epochs with ``--profile_steps 2`` (A, B', C', D', E' and F named in the
   trace; each epoch's background checkpoint bit-equal to a synchronous
   snapshot at the same call), and a real SIGTERM to the CLI's process;
10. data parallelism (``phase_data_parallel``), then height-sharded
   spatial parallelism over two slabs (two names of cuda:0 on a one-card
   machine, every GPU on more), each check fatal:
   ``phase_spatial_kernels``: (a) C' and C'' at B=4 and D', E', D'' and
   E'' at B=3 at the rectangular shapes of a 1024px image over two slabs
   (Sq=8,192, Skv=16,384), each against its plain version, timed beside
   its bound and SDPA on the same shapes; (b) B' and B'' fed given
   statistics on halo-extended slabs at three encoder sites of a batch of
   4, and the stats pass on a slab's own rows, against their plain
   versions; ``phase_spatial``: (c) ``TaggerEngine.with_spatial`` at
   1024px, fp32 and bf16, batch 4 and 1, against one engine on the same
   pixels (fp32 latents MSE < 1e-10, probabilities 1e-5 fp32 and 1e-2
   bf16, exact launches: every kernel once a slab, and the slab's stats
   pass at each A site); (d) one train_full step (simplified loss) in
   bf16 and fp32 against the unsharded step on the same batch and
   generator (loss rel 1e-5 fp32, 1e-2 bf16; every fp32 gradient rel
   1e-3; exact launches, D and E once a slab; the step time and peak
   memory of both); (e) one train_vae step the same way, its decoder on
   the slabs too, the fp32 gradient gate over every parameter and the
   bf16 step time; (f) the infer CLI and train_full's fp32 CLI in this
   process with ``parallel.mesh.local_devices`` giving the slab devices:
   the JSON within 1e-5 (one 4-decimal rounding) and the training loss
   within rel 1e-4 of the runs without --spatial_parallel, exact launches;
11. the Wan 2.1 VAE's encoder (``phase_wan``), at the shapes of its bf16
   benchmark cell (a batch of 8 at 1024px), each check fatal: the RMS
   stats pass and the apply pass on 8 x 1024^2 x 96 in both dtypes; the
   fused residual branch at each of the encoder's twelve distinct shapes
   (96, 192 and 384 channels; plain, residual, shortcut): the stats pass
   and B' in its RMS mode in bf16, the stats and apply passes and B'' in
   fp32; C' and C'' at B=8, S=16,384, D=384; each against its plain
   version (fp32 within 1e-4 relative, 1e-5 for the RMS passes; bf16
   within 4x the plain bf16 error) and timed beside its bound; then
   ``AutoencoderKLWan`` at the published widths on one seeded 1024px image,
   its moments against the plain path in both dtypes, and the exact
   launches of one encode (bf16: stats 22, B' 20, apply 2, C' 1; fp32:
   stats 22, apply 22, B'' 20, C'' 1);
12. kernel A's device time by kernel (torch.profiler), new and its first
   form's (csrc/groupnorm_silu.cu), at
   each stats site with its bandwidth, and of A's two passes: last, since a
   profiler session may slow the host's launches after it;
13. one JSON line ``{"kernels": [...]}`` (each kernel's launches on every
   path, ``launches_by_path``, the train_vae, tiled, train_decoder,
   bucket, serve, attention-map, drill, data-parallel and spatial paths
   included, ``spatial_launches`` on its spatial train_full step, its
   decoder-site numbers under ``decoder``, the tile and bucket shapes'
   under ``tile_bucket`` and the spatial shapes' under ``spatial``), then
   as the last line ``{"ok": true, "device": {...}}``.

With ``--report PATH`` the full report is also written there as JSON.
With ``--parent-tree DIR`` (a checkout of another commit, such as a ``git
archive`` of the parent under build/archive/) that tree's kernel F is timed
beside this one's in phase_kernel_f, and before the device breakdown
``phase_parent_compare`` times kernel F's sites and the train_full and
train_vae steps of both trees, each in a child process (``--measure-tree``),
in the order parent, this, this, parent.
"""

from __future__ import annotations

import contextlib
import copy
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
# every phase runs on the card; the entry points are told so (--device)
DEVICE = "cuda"

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
    "group_norm_silu_bwd": dict(
        route="cuda",
        source="vae_tagger_tpu_torch/csrc/groupnorm_silu_bwd.cu",
        replaces="no Pallas kernel: XLA's fused GroupNorm/SiLU VJP inside "
                 "jax.vjp(reference), vae_tagger_tpu/ops/conv.py:321 and "
                 "vae_tagger_tpu/ops/normalization.py:92"),
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
def _plus(*counts):
    """The sum of launch-count dicts."""
    out = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


# launches of one encode batch, bf16 and fp32
ENCODE_LAUNCHES = {
    "bf16": {"group_norm_silu": 2, "group_stats": 20, "gn_silu_conv3x3_tc": 20,
             "flash_attention_fwd_tc": 1},
    "fp32": {"group_norm_silu": 2, "group_stats": 20,
             "gn_silu_conv3x3_tf32x3": 20, "flash_attention_fwd_tf32x3": 1},
}


def _gn_backward_launches(forward):
    """The GroupNorm sites' backward of one forward with ``forward``'s
    launches: kernel F once at every site (the A sites and the fused
    convs), and A's apply pass once at every fused conv, recomputing its
    activation for cuDNN's conv backward."""
    fused = sum(n for k, n in forward.items()
                if k.startswith("gn_silu_conv3x3"))
    return {"group_norm_silu": fused,
            "group_norm_silu_bwd": fused + forward.get("group_norm_silu", 0)}


# launches of one train step: the encode's, then the attention backward (E'
# and E'' each run a dV pass and a dK pass) and the GroupNorm sites'
# backward; a validation batch runs the encode's alone
TRAIN_STEP_LAUNCHES = {
    "bf16": _plus(ENCODE_LAUNCHES["bf16"],
                  _gn_backward_launches(ENCODE_LAUNCHES["bf16"]),
                  dict(flash_attention_bwd_dq_tc=1,
                       flash_attention_bwd_dkv_tc=2)),
    "fp32": _plus(ENCODE_LAUNCHES["fp32"],
                  _gn_backward_launches(ENCODE_LAUNCHES["fp32"]),
                  dict(flash_attention_bwd_dq_tf32x3=1,
                       flash_attention_bwd_dkv_tf32x3=2)),
}
# launches of the fp32 gradient gate's kernel-path forward and backward
GATE_LAUNCHES = TRAIN_STEP_LAUNCHES["fp32"]

# The 28 fused convs of one FLUX decoder forward at 1024px (batch 1 in a
# train_vae step): (H=W, Cin, Cout, variant, Cres, launches per forward).
# New against the encoder's: Cin > Cout (512->256 at 512^2, 256->128 at
# 1024^2) and the 1x1 shortcut from Cres > Cout.
DEC_B_CASES = [
    (128, 512, 512, "plain", None, 5),
    (128, 512, 512, "residual", 512, 5),
    (256, 512, 512, "plain", None, 3),
    (256, 512, 512, "residual", 512, 3),
    (512, 512, 256, "plain", None, 1),
    (512, 256, 256, "shortcut", 512, 1),
    (512, 256, 256, "plain", None, 2),
    (512, 256, 256, "residual", 256, 2),
    (1024, 256, 128, "plain", None, 1),
    (1024, 128, 128, "shortcut", 256, 1),
    (1024, 128, 128, "plain", None, 2),
    (1024, 128, 128, "residual", 128, 2),
]
DEC_B_PER_FORWARD = sum(c[-1] for c in DEC_B_CASES)
# the decoder's stats sites (the inputs of DEC_B_CASES) that no encoder
# forward has, and its A site (conv_norm_out); batch 1
DEC_NEW_STATS_SITES = [(512, 512), (1024, 256)]
DEC_A_SITE = (1024, 128)


# launches of one decode: A at the attention norm and conv_norm_out, the
# stats pass before each fused conv, C once
DECODE_LAUNCHES = {
    "bf16": {"group_norm_silu": 2, "group_stats": 28,
             "gn_silu_conv3x3_tc": 28, "flash_attention_fwd_tc": 1},
    "fp32": {"group_norm_silu": 2, "group_stats": 28,
             "gn_silu_conv3x3_tf32x3": 28, "flash_attention_fwd_tf32x3": 1},
}
# a train_vae step (and a full-loss train_full step) at batch 1: the
# stacked encode, the anchor's decode, the backward of both attentions and
# of every GroupNorm site; a validation batch runs both forwards alone
VAE_FORWARD_LAUNCHES = {k: _plus(ENCODE_LAUNCHES[k], DECODE_LAUNCHES[k])
                        for k in ENCODE_LAUNCHES}
VAE_STEP_LAUNCHES = {
    k: _plus(VAE_FORWARD_LAUNCHES[k],
             _gn_backward_launches(VAE_FORWARD_LAUNCHES[k]),
             {n: 2 * c for n, c in TRAIN_STEP_LAUNCHES[k].items()
              if n.startswith("flash_attention_bwd")})
    for k in ENCODE_LAUNCHES}


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

    def __init__(self, name, dtypes=("fp32", "bf16"), tol32=1e-4):
        self.name = name
        self.dtypes = dtypes
        self.tol32 = tol32
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
                ok = ok and e32 <= self.tol32 and finite(k32[i])
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


def _train_gn_sites():
    """[(N, H, W, C, apply_silu, sites, what)]: kernel F's shapes in a step.
    The 22 GroupNorm sites of a train_full step at RES (TRAIN_ROWS images):
    the inputs of B_CASES and the two A sites (the mid-block attention's
    norm, no SiLU, and conv_norm_out); then the decoder's sites no encoder
    has (a train_vae step decodes one image): the inputs of its 512->256
    and 256->128 convs and its conv_norm_out."""
    out = [(TRAIN_ROWS, hw, hw, c, True, sites, "train_full")
           for (hw, c), sites in _stats_shapes().items()]
    out += [(TRAIN_ROWS, RES // 8, RES // 8, 512, silu, 1, "train_full")
            for silu in (False, True)]
    out += [(1, hw, hw, c, True, 1, "train_vae decoder")
            for hw, c in (*DEC_NEW_STATS_SITES, DEC_A_SITE)]
    return out


F_KERNELS = ("gn_bwd_reduce_kernel", "gn_bwd_apply_kernel")
# the profiler range around each call of kernel F's wrapper
F_RANGE = "chip_smoke: kernel F call"


def _annotation(evt):
    """Whether a device-side profiler record is a range's GPU annotation (an
    F range's, or one of the port's own ``vt:`` spans), which repeats the
    device time of the work inside the range and is no work of its own."""
    from vae_tagger_tpu_torch.utils.profiling import PREFIX

    return (getattr(evt, "is_user_annotation", False)
            or evt.key == F_RANGE or evt.key.startswith(PREFIX))


def _f_device(fn, reps=5):
    """Device ms of one call of fn() (kernel F's wrapper) and the names of
    the kernels each call launches, from torch.profiler: each of 1 + reps
    calls in an F range of its own (_f_range_kernels), the first one, a
    warm-up, left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(1 + reps):
                with record_function(F_RANGE):
                    fn()
            torch.cuda.synchronize()
        calls = _f_range_kernels(prof)[1:]
        assert len(calls) == reps, len(calls)
        if not any(_f_records_missing(names) for names, _ in calls):
            break
    return (sum(us for _, us in calls) / 1e3 / reps,
            [names for names, _ in calls])


def _f_inputs(g, n, h, w, c):
    """Kernel F's inputs at one site: x, dAct, the GroupNorm scale and
    bias, x's fp32 statistics and their effective affine (bf16-representable
    values)."""
    from vae_tagger_tpu_torch.ops.normalization import (
        effective_affine,
        group_stats_plain,
    )

    x = _rnd(g, n, h, w, c, shift=0.3)
    d = _rnd(g, n, h, w, c)
    gs = _rnd(g, c, scale=0.2, shift=1.0)
    gb = _rnd(g, c, scale=0.1)
    mean, meansq = group_stats_plain(x, GROUPS)
    es, eb = effective_affine(mean, meansq, gs, gb, c, 1e-6)
    return x, d, gs, gb, mean, meansq, es, eb


def _f_cases():
    """phase_kernel_f's sites: the train_full step's, the decoder's new
    ones and a halo-extended slab of a 1024px image over two slabs (as
    phase_spatial_kernels' first site, with given statistics)."""
    return _train_gn_sites() + [(BATCH, RES // 2 + 1, RES, 128, True, 1,
                                 "spatial slab")]


def _f_site_times(g):
    """Kernel F's timing loop (CUDA events) and device ms (torch.profiler)
    summed over a step's calls at each group of _f_cases, and the kernels
    one call launches, in bf16 and fp32: the measurement of phase_kernel_f,
    made by this script's --measure-tree on another tree's package."""
    import torch
    from vae_tagger_tpu_torch.ops.normalization import (
        group_norm_silu_backward,
    )

    tot = {}
    for n, h, w, c, silu, sites, what in _f_cases():
        x, d, gs, _, mean, meansq, es, eb = _f_inputs(g, n, h, w, c)
        for dt in (torch.bfloat16, torch.float32):
            xs, ds = x.to(dt), d.to(dt)

            def fn(xs=xs, ds=ds, silu=silu, st=what != "spatial slab"):
                return group_norm_silu_backward(
                    xs, ds, mean, meansq, gs, es, eb, apply_silu=silu,
                    stats_term=st)

            ms = time_ms(fn)
            dev_ms, calls = _f_device(fn)
            t = tot.setdefault(f"{what}|{str(dt).removeprefix('torch.')}",
                               dict(ms=0.0, device_ms=0.0))
            t["ms"] += sites * ms
            t["device_ms"] += sites * dev_ms
            t["kernels_per_call"] = len(calls[-1])
            del xs, ds
        del x, d
        torch.cuda.empty_cache()
    return tot


def _tree_child(tree, steps=None):
    """This script's --measure-tree in a child process on the port's
    package of ``tree`` (a checkout, such as a ``git archive`` of a parent
    commit): kernel F's site times (_f_site_times) and, with ``steps`` (the
    artifacts and data.json), the steady steps (_tree_steps).  Returns the
    child's report, its last line."""
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--measure-tree",
           str(tree)]
    if steps is not None:
        cmd += ["--steps", json.dumps(steps)]
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=1500)
    for ln in run.stdout.splitlines()[:-1]:
        log(f"    [{Path(tree).name}] {ln}")
    if run.returncode != 0:
        raise RuntimeError(f"--measure-tree {tree} failed:\n{run.stderr}")
    return json.loads(run.stdout.splitlines()[-1])


def phase_kernel_f(g, results, parent_tree=None):
    """Kernel F (GroupNorm(+SiLU) backward) against its plain version at
    every GroupNorm site shape of a train_full step at RES with TRAIN_ROWS
    images, at the decoder's new sites of a train_vae step, and on the
    height slab of phase_spatial_kernels' first site with given statistics
    (no statistics' term in dx; dmean and dmeansq out): fp32 rel <= 1e-5 on
    every output, bf16 against the plain fp32 version within 4x the plain
    bf16 version's own error.  Timed in both dtypes, summed over a step's
    sites, beside its bytes bound, the plain version and autograd of
    F.group_norm + F.silu (the library's backward at the same shape); two
    launches bit-identical at a 1024^2 and a 128^2 site.  Each call's device
    time (torch.profiler) beside its timing loop, and the kernels it
    launches: exactly F's two.  With ``parent_tree`` (a checkout of the
    parent commit) the parent's F is timed the same way in a child process
    (_tree_child) on the same card."""
    import torch
    import torch.nn.functional as F
    from vae_tagger_tpu_torch.ops.normalization import (
        group_norm_silu_backward,
    )

    cases = _f_cases()
    n_sites = sum(c[5] for c in cases if c[6] == "train_full")
    log(f"kernel F: group_norm_silu_backward at the {n_sites} GroupNorm "
        f"sites of a train_full step ({TRAIN_ROWS} images at {RES}px), the "
        f"decoder's new sites and a spatial slab")
    chk = Check("group_norm_silu_bwd", tol32=1e-5)
    tot = {(what, dt): dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0,
                            device_ms=0.0)
           for what in ("train_full", "train_vae decoder", "spatial slab")
           for dt in (torch.bfloat16, torch.float32)}
    repeats, sites_log = [], []
    for n, h, w, c, silu, sites, what in cases:
        x, d, gs, gb, mean, meansq, es, eb = _f_inputs(g, n, h, w, c)
        xs, ds = _both(x), _both(d)
        stats_term = what != "spatial slab"

        def op(dt, silu=silu, stats_term=stats_term):
            out = group_norm_silu_backward(
                xs[dt], ds[dt], mean, meansq, gs, es, eb, apply_silu=silu,
                stats_term=stats_term)
            return tuple(t for t in out if t is not None)

        label = (f"{what} N={n} {h}x{w} C={c} silu={silu}"
                 + (" given stats" if not stats_term else ""))
        chk.run(label, op)
        for dt in (torch.bfloat16, torch.float32):
            with torch.enable_grad():
                xl = xs[dt].permute(0, 3, 1, 2).detach().requires_grad_()
                wl, bl = (t.to(dt).detach().clone().requires_grad_()
                          for t in (gs, gb))
                y = F.group_norm(xl, GROUPS, wl, bl, 1e-6)
                y = F.silu(y) if silu else y
            dy = ds[dt].permute(0, 3, 1, 2)

            def library(y=y, xl=xl, wl=wl, bl=bl, dy=dy):
                return torch.autograd.grad(y, (xl, wl, bl), dy,
                                           retain_graph=True)

            ms, plain_ms, library_ms = time_kernel(op, dt, library)
            dev_ms, calls = _f_device(lambda dt=dt: op(dt))
            # exactly F's two kernels a call: the fold runs inside the
            # reduce pass, and no copy of x or dAct
            kernels = calls[-1]
            assert all(sorted(ks) == sorted(F_KERNELS) for ks in calls), (
                label, dt, calls)
            t = tot[(what, dt)]
            t["ms"] += sites * ms
            t["device_ms"] += sites * dev_ms
            t["plain_ms"] += sites * plain_ms
            t["library_ms"] += sites * library_ms
            # read x and dAct once, write dx once
            nbytes = 3 * x.numel() * xs[dt].element_size()
            t["nbytes"] += sites * nbytes
            sites_log.append(dict(case=label, dtype=str(dt), sites=sites,
                                  ms=ms, device_ms=dev_ms,
                                  bound_ms=nbytes / PEAK_BYTES * 1e3))
            log(f"  {label} {str(dt).removeprefix('torch.')} x{sites}: "
                f"{ms:.4f} ms (device {dev_ms:.4f}, bytes bound "
                f"{nbytes / PEAK_BYTES * 1e3:.4f}; kernels a call "
                f"{kernels}), plain {plain_ms:.4f}, F.group_norm"
                f"{' + F.silu' if silu else ''} backward {library_ms:.4f}")
            if (h, c) in ((RES, 128), (RES // 8, 512)) and silu \
                    and what == "train_full":
                same = _same_twice(lambda dt=dt: op(dt))
                assert same, f"kernel F repeats differ: {label} {dt}"
                repeats.append(f"{label} {dt}")
            del y, xl, wl, bl, dy
        del x, d, xs, ds
        torch.cuda.empty_cache()
    out = {}
    for (what, dt), t in tot.items():
        # about 20 fp32 operations an element on the CUDA cores
        b_ms, b_by = bound(t["nbytes"], 20 * t["nbytes"] / 3 / (
            2 if dt == torch.bfloat16 else 4), "float32")
        out[(what, dt)] = dict(t, bound_ms=b_ms, bound_by=b_by)
        log(f"  F, {what}, {str(dt).removeprefix('torch.')}: {t['ms']:.3f} "
            f"ms (device {t['device_ms']:.3f}); bound {b_ms:.3f} ms "
            f"({b_ms / t['ms']:.1%}; device {b_ms / t['device_ms']:.1%}); "
            f"plain {t['plain_ms']:.3f}, library {t['library_ms']:.3f}")
    parent = None
    if parent_tree is not None:
        log(f"  kernel F of the parent tree {parent_tree}, the same sites:")
        parent = _tree_child(parent_tree)["f"]
        for key, t in parent.items():
            what, dt = key.split("|")
            new = out[(what, getattr(torch, dt))]
            log(f"  F, {what}, {dt}: parent {t['ms']:.3f} ms (device "
                f"{t['device_ms']:.3f}, {t['kernels_per_call']} kernels a "
                f"call) -> {new['ms']:.3f} (device {new['device_ms']:.3f})")
    bf = out[("train_full", torch.bfloat16)]
    f32 = out[("train_full", torch.float32)]
    results["group_norm_silu_bwd"] = dict(
        chk.summary(), ms=bf["ms"], plain_ms=bf["plain_ms"],
        library_ms=bf["library_ms"], bound_ms=bf["bound_ms"],
        bound_by=bf["bound_by"], device_ms=bf["device_ms"],
        ms_fp32=f32["ms"], device_ms_fp32=f32["device_ms"],
        plain_ms_fp32=f32["plain_ms"], library_ms_fp32=f32["library_ms"],
        bound_ms_fp32=f32["bound_ms"], bit_identical_repeats=repeats,
        kernels_per_call=len(F_KERNELS), sites=sites_log,
        **({"parent": parent} if parent is not None else {}),
        decoder={k: out[("train_vae decoder", dt)][k.removesuffix("_fp32")]
                 for dt, sfx in ((torch.bfloat16, ""), (torch.float32,
                                                       "_fp32"))
                 for k in (f"ms{sfx}", f"device_ms{sfx}", f"plain_ms{sfx}",
                           f"library_ms{sfx}", f"bound_ms{sfx}")},
        spatial={k: out[("spatial slab", dt)][k.removesuffix("_fp32")]
                 for dt, sfx in ((torch.bfloat16, ""), (torch.float32,
                                                       "_fp32"))
                 for k in (f"ms{sfx}", f"device_ms{sfx}", f"plain_ms{sfx}",
                           f"library_ms{sfx}", f"bound_ms{sfx}")},
        library="autograd of F.group_norm (+ F.silu), channels_last",
        per=f"the 22 GroupNorm sites of a train_full step ({TRAIN_ROWS} "
            f"images at {RES}px), one call each; ms, plain_ms, library_ms "
            f"and bound_ms bf16, *_fp32 fp32; decoder: its 3 new sites at "
            f"batch 1; spatial: one slab of N={BATCH} (513x1024, C=128)")


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


def phase_decoder_kernels(g, results):
    """The decoder's sites of kernels B', B'', A and its stats pass at
    batch 1 (a train_vae step decodes the anchor alone): B' and B'' at the
    28 fused convs of DEC_B_CASES against their plain versions (bf16 and
    fp32) and timed beside them and cuDNN; the stats pass at the two sites
    no encoder has (512^2 C=512, 1024^2 C=256) and A at conv_norm_out
    (1024^2 C=128) in both dtypes, timed beside torch.var_mean and
    F.group_norm + F.silu.  The totals go beside each kernel's encode
    numbers (``decoder`` in its report)."""
    import torch
    import torch.nn.functional as F
    from vae_tagger_tpu_torch.ops.conv import gn_silu_conv3x3
    from vae_tagger_tpu_torch.ops.normalization import (
        group_norm_affine,
        group_norm_silu,
    )

    log(f"the decoder's sites, batch 1 at {RES}px: B' (bf16) and B'' (fp32) "
        f"at its {DEC_B_PER_FORWARD} fused convs, the stats pass at "
        f"{DEC_NEW_STATS_SITES}, A at {DEC_A_SITE}")
    dts = {"gn_silu_conv3x3_tc": torch.bfloat16,
           "gn_silu_conv3x3_tf32x3": torch.float32}
    chk = {name: Check(name, ("bf16",) if dt == torch.bfloat16 else
                       ("fp32",)) for name, dt in dts.items()}
    tot = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0,
                      nbytes=0.0, cases=[]) for name in dts}
    for hw, cin, cout, variant, cres, mult in DEC_B_CASES:
        x = _rnd(g, 1, hw, hw, cin)
        gs = _rnd(g, cin, scale=0.2, shift=1.0)
        gb = _rnd(g, cin, scale=0.1)
        k = _rnd(g, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        b = _rnd(g, cout, scale=0.1)
        res = _rnd(g, 1, hw, hw, cres) if cres else None
        sck = (_rnd(g, cres, cout, scale=cres ** -0.5)
               if variant == "shortcut" else None)
        scb = _rnd(g, cout, scale=0.1) if variant == "shortcut" else None
        xs, rs = _both(x), _both(res)

        def op(dt):
            return gn_silu_conv3x3(xs[dt], gs, gb, k, b, rs[dt], sck, scb,
                                   num_groups=GROUPS)

        label = f"{hw}^2 {cin}->{cout} {variant}" + (
            f" Cres={cres}" if variant == "shortcut" else "")
        for name in dts:
            chk[name].run(label, op)
        m = hw * hw
        k_dim = 9 * cin + (cres if variant == "shortcut" else 0)
        for name, dt in dts.items():
            w_oihw = k.to(dt).permute(3, 2, 0, 1).contiguous()
            sc_oihw = (None if sck is None
                       else sck.to(dt).t()[:, :, None, None].contiguous())

            def library(dt=dt, w_oihw=w_oihw, sc_oihw=sc_oihw):
                y = F.silu(F.group_norm(xs[dt].permute(0, 3, 1, 2), GROUPS,
                                        gs.to(dt), gb.to(dt), 1e-6))
                out = F.conv2d(y, w_oihw, b.to(dt), padding=1)
                if sc_oihw is not None:
                    out = out + F.conv2d(rs[dt].permute(0, 3, 1, 2), sc_oihw,
                                         scb.to(dt))
                elif rs[dt] is not None:
                    out = out + rs[dt].permute(0, 3, 1, 2)
                return out

            ms, plain_ms, lib_ms = time_kernel(op, dt, library)
            esize = 2.0 if dt == torch.bfloat16 else 4.0
            flops = 2.0 * m * k_dim * cout
            nbytes = esize * (m * cin + m * cout + (m * cres if cres else 0)
                              + k_dim * cout)
            t = tot[name]
            t["ms"] += mult * ms
            t["plain_ms"] += mult * plain_ms
            t["library_ms"] += mult * lib_ms
            t["flops"] += mult * flops
            t["nbytes"] += mult * nbytes
            b_ms = (bound(nbytes, flops) if dt == torch.bfloat16
                    else _fp32_bounds(nbytes, flops)[1])[0]
            t["cases"].append(dict(case=label, launches=mult, ms=ms,
                                   plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=b_ms))
            log(f"  {name} {label}: {ms:.3f} ms a call (bound {b_ms:.3f}, "
                f"{b_ms / ms:.1%}), plain {plain_ms:.3f}, cuDNN {lib_ms:.3f}")
        del x, xs, res, rs
        torch.cuda.empty_cache()
    for name, dt in dts.items():
        t = tot[name]
        if dt == torch.bfloat16:
            b_ms, b_by = bound(t["nbytes"], t["flops"])
        else:
            b_ms, b_by = _fp32_bounds(t["nbytes"], t["flops"])[1]
        log(f"  {name}, the decoder's {DEC_B_PER_FORWARD} convs at batch 1: "
            f"{t['ms']:.3f} ms, bound {b_ms:.3f} ({b_ms / t['ms']:.1%}, "
            f"{b_by}), plain {t['plain_ms']:.3f}, cuDNN "
            f"{t['library_ms']:.3f} ms")
        results[name]["decoder"] = dict(
            chk[name].summary(), ms=t["ms"], plain_ms=t["plain_ms"],
            library_ms=t["library_ms"], bound_ms=b_ms, bound_by=b_by,
            flops=t["flops"], cases=t["cases"],
            per=f"{DEC_B_PER_FORWARD} launches: one decode at batch 1, "
                f"{RES}px")

    chk_s, chk_a = Check("group_stats"), Check("group_norm_silu")
    stats_rows, a_rows = [], []
    for hw, c in DEC_NEW_STATS_SITES + [DEC_A_SITE]:
        x = _rnd(g, 1, hw, hw, c, shift=0.3)
        gs = _rnd(g, c, scale=0.2, shift=1.0)
        gb = _rnd(g, c, scale=0.1)
        xs = _both(x)
        is_a = (hw, c) == DEC_A_SITE
        for silu in ((False, True) if is_a else (None,)):
            def op(dt, silu=silu):
                if is_a:
                    return group_norm_silu(xs[dt], gs, gb, num_groups=GROUPS,
                                           apply_silu=silu)
                return group_norm_affine(xs[dt], gs, gb, num_groups=GROUPS)

            (chk_a if is_a else chk_s).run(
                f"{hw}^2 C={c}" + (f" silu={silu}" if is_a else ""), op)
            for dt in (torch.bfloat16, torch.float32):
                xd = xs[dt]
                nbytes = xd.numel() * xd.element_size() * (2 if is_a else 1)

                def library(xd=xd, dt=dt, silu=silu):
                    if not is_a:
                        return torch.var_mean(
                            xd.view(1, hw * hw, GROUPS, -1).float(),
                            dim=(1, 3), correction=0)
                    y = F.group_norm(xd.permute(0, 3, 1, 2), GROUPS,
                                     gs.to(dt), gb.to(dt), 1e-6)
                    return F.silu(y) if silu else y

                ms, plain_ms, lib_ms = time_kernel(op, dt, library)
                b_ms = nbytes / PEAK_BYTES * 1e3
                row = dict(hw=hw, c=c, dtype=str(dt).removeprefix("torch."),
                           silu=silu, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=b_ms, bound_by="bytes")
                (a_rows if is_a else stats_rows).append(row)
                log(f"  {'A' if is_a else 'stats pass'} {hw}^2 C={c} "
                    f"{row['dtype']}" + (f" silu={silu}" if is_a else "")
                    + f": {ms:.4f} ms (bound {b_ms:.4f}, {b_ms / ms:.0%}), "
                    f"plain {plain_ms:.4f}, "
                    f"{'F.group_norm+F.silu' if is_a else 'torch.var_mean'} "
                    f"{lib_ms:.4f}")
        del x, xs
        torch.cuda.empty_cache()
    results["group_stats"]["decoder"] = dict(chk_s.summary(),
                                             sites=stats_rows)
    results["group_norm_silu"]["decoder"] = dict(chk_a.summary(),
                                                 sites=a_rows)


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


# profiler sessions a measurement may take when CUPTI hands back a session
# with device records missing (seen on the card, rarely: a session with no
# kernel at all, or one without its first kernel)
PROFILE_ATTEMPTS = 3


def _device_ms_by_kernel(fn, reps=10):
    """Device time of one call of fn() by kernel name, from torch.profiler
    over ``reps`` calls after a warm-up call; a session that recorded no
    device work is taken again (PROFILE_ATTEMPTS)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", 0) or 0
            if evt.device_type != DeviceType.CUDA or us <= 0 \
                    or _annotation(evt):
                continue
            name = re.search(r"(\w+_kernel)", evt.key)
            key = name.group(1) if name else evt.key[:60]
            out[key] = out.get(key, 0.0) + us / 1e3 / reps
        if out:
            return out
    raise RuntimeError(f"{PROFILE_ATTEMPTS} profiler sessions recorded no "
                       f"device work")


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
        # no statistics kept: a forward-only yardstick
        return _simt_conv(x.contiguous(), gs, gb, kern.float(), bias.float(),
                          res, None if sck is None else sck.float(),
                          None if scb is None else scb.float(), num_groups,
                          eps), "gn_silu_conv3x3", None

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
    """Seeded full-width weights in diffusers layout (the whole VAE, its
    decoder included), a head .bin, tags and PNGs under build/chip_smoke."""
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
    # the encoder as seeded_init_ gives it alone (the weights of the runs
    # before the decoder was ported), the decoder seeded beside it
    vae = seeded_init_(AutoencoderKL(cfg, with_decoder=True), SEED)
    vae.load_state_dict(seeded_init_(AutoencoderKL(cfg), SEED).state_dict(),
                        strict=False)
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
    """The seeded images as a tagged dataset: data.json of weighted tag
    prompts over the 2,000 tags."""
    import numpy as np

    rng = np.random.default_rng(SEED + 3)
    data = {}
    for p in sorted(Path(art["images"]).glob("*.png")):
        # tags drawn from a pool of 24 so that triplets find positives
        tags = rng.choice(24, size=rng.integers(2, 6), replace=False)
        data[str(p)] = ", ".join(f"tag_{t}:{rng.uniform(0.5, 1.0):.2f}"
                                 for t in tags)
    path = WORK / "data.json"
    path.write_text(json.dumps(data, indent=1))
    return str(path)


# kernel-name patterns of the device time outside the port's kernels, in
# the order they are tried (a cuDNN conv's name may also say gemm).  cuDNN's
# FFT convolutions (fp32 with TF32 off) run complex GEMMs and GEMVs (cf32,
# float2) between their transforms; by name they belong to no one pass.
OTHER_KERNELS = (
    ("cuDNN conv forward (fprop)",
     r"fprop|convolve_sgemm|conv2d_grouped_direct|conv\w*fwd|fwd\w*conv"),
    ("cuDNN conv dgrad", r"dgrad"),
    ("cuDNN conv wgrad", r"wgrad"),
    ("cuDNN conv, FFT (complex GEMM, transforms), winograd, layout",
     r"fft|cf32|float2|winograd|cudnn|nchwToNhwc|nhwcToNchw"),
    ("optimizer (clip + AdamW, foreach)",
     r"multi_tensor_apply|lpnorm|LpNorm|Adam"),
    ("cuBLAS (head, shortcut, attention projections)",
     r"nvjet|gemm|gemv|splitK|cublas|cutlass"),
)
OTHER_REST = "elementwise, reductions, copies (torch)"


def _kernel_breakdown(prof):
    """Device time of one profiled step by kernel: the port's kernels by
    name, everything else by OTHER_KERNELS' patterns (cuDNN's conv passes,
    cuBLAS, the optimizer) and the rest (torch's elementwise, reductions
    and copies)."""
    names = {"conv3x3_kernel": "gn_silu_conv3x3",
             "conv3x3_tc_kernel": "gn_silu_conv3x3_tc",
             "conv3x3_tf32x3_kernel": "gn_silu_conv3x3_tf32x3",
             "flash_fwd_tc_kernel": "flash_attention_fwd_tc",
             "flash_fwd_tf32x3_kernel": "flash_attention_fwd_tf32x3",
             "gn_stats_vec_kernel": "group_stats (+A's stats)",
             "gn_apply_vec_kernel": "group_norm_silu (apply)",
             "gn_bwd_reduce_kernel": "group_norm_silu_bwd (F reduce)",
             "gn_bwd_apply_kernel": "group_norm_silu_bwd (F apply)",
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

    by_kernel, top, calls = {}, [], {}
    for evt in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' time, and a
        # range's device-side annotation those of the work inside it
        us = getattr(evt, "self_device_time_total", 0) or 0
        if (evt.device_type != DeviceType.CUDA or us <= 0
                or _annotation(evt)):
            continue
        top.append((us / 1e3, evt.key[:90]))
        label = next((v for k, v in names.items() if k in evt.key), None)
        if label is None:
            label = next((lab for lab, pat in OTHER_KERNELS
                          if re.search(pat, evt.key)), OTHER_REST)
        by_kernel[label] = by_kernel.get(label, 0.0) + us / 1e3
        calls[label] = calls.get(label, 0) + evt.count
    top.sort(reverse=True)
    return by_kernel, top[:12], calls


def _conv_ops(prof):
    """Calls of cuDNN's forward convolution and of the conv backward in a
    profile, by operator (the dispatcher records both)."""
    want = ("aten::cudnn_convolution", "aten::convolution_backward")
    found = {k: 0 for k in want}
    for evt in prof.key_averages():
        if evt.key in found:
            found[evt.key] += evt.count
    return found


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


def _train_cli(art, json_path, precision, trainer="train_full", flags=(),
               n_images=N_IMAGES, shards=1):
    """One epoch of ``python -m vae_tagger_tpu_torch.train.<trainer>``'s
    entry point at ``--mixed_precision precision`` ("bf16" or "no"), with
    ``flags`` added, the launch counts reset just before it and read just
    after.  Checks the exact launches (train_full's final evaluation
    included), finite losses, every encoder parameter changed, and the
    VAE decoder: changed where the loss trains it (train_vae, the full
    loss), exported exactly as loaded where it does not (the simplified
    loss); train_full's head changed and its final evaluation's files
    written; the adaptive loss weights moved from zero where they are
    trained.  ``shards`` > 1: the run shards each image over that many
    height slabs (--spatial_parallel), which multiplies the launches.
    Returns the trained state, the output directory and a report."""
    import numpy as np
    import torch
    from safetensors.torch import load_file
    from vae_tagger_tpu_torch.data.loader import train_val_split
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.train import train_full, train_vae

    key = "bf16" if precision == "bf16" else "fp32"
    full_loss = "--no_simplified_loss" in flags
    vae_trained = trainer == "train_vae" or full_loss
    out = WORK / (f"{trainer}_out_{key}{'_full_loss' if full_loss else ''}"
                  f"{'_buckets' if '--use_bucketing' in flags else ''}"
                  f"{'_spatial' if shards > 1 else ''}")
    argv = ["--json_path", json_path, "--tags_csv_path", art["tags"],
            "--vae_checkpoint", art["vae"], "--vae_config_path",
            art["config"], "--output_dir", str(out), "--resolution",
            str(RES), "--train_batch_size", "1", "--num_epochs", "1",
            "--mixed_precision", precision, "--lr_warmup_steps", "0",
            "--save_steps", "1", "--logging_steps", "1", "--num_workers", "4",
            "--seed", str(SEED), "--device", DEVICE, *flags]
    if trainer == "train_full":
        argv += ["--decoder_checkpoint", art["decoder"]]
    n_train, n_val = (len(ix) for ix in train_val_split(n_images, 0.1,
                                                        seed=SEED or 42))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    main = train_full.main if trainer == "train_full" else train_vae.main
    state = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = backend.launch_counts()
    cli_peak = torch.cuda.max_memory_allocated()
    name = f"{trainer} {key}{' ' + ' '.join(flags) if flags else ''}"
    log(f"  CLI, {name}: {n_train} train steps + {n_val} validation batch"
        f"{' + the final evaluation' if trainer == 'train_full' else ''} in "
        f"{wall:.2f} s (load, exports and checkpoints included), peak "
        f"device memory {cli_peak / 2**30:.2f} GiB")
    log(f"  launches, {name}: {counts}")
    step = (VAE_STEP_LAUNCHES if vae_trained else TRAIN_STEP_LAUNCHES)[key]
    val = (VAE_FORWARD_LAUNCHES if vae_trained else ENCODE_LAUNCHES)[key]
    # train_full's final phase encodes each validation batch once more
    final = ENCODE_LAUNCHES[key] if trainer == "train_full" else {}
    if shards > 1:
        step, val, final = (_spatial_launches(c, shards)
                            for c in (step, val, final))
    expect = {k: n_train * step.get(k, 0) + n_val * val.get(k, 0)
              + n_val * final.get(k, 0) for k in counts}
    for k, want in expect.items():
        assert counts[k] == want, (name, k, counts[k], want)

    history = json.loads((out / "training_history.json").read_text())
    values = (history["train_loss"] + history["val_loss"]
              + [v for vs in history["train_metrics"].values() for v in vs])
    assert values and all(np.isfinite(values)), history
    log(f"  losses, {name}: train {history['train_loss']}, val "
        f"{history['val_loss']}, terms "
        f"{ {k: v for k, v in history['train_metrics'].items()} }")

    before_vae = load_file(art["vae"])
    after_vae = load_file(str(out / "vae" /
                              "diffusion_pytorch_model.safetensors"))
    assert set(after_vae) == set(before_vae), "the export is not a whole VAE"
    enc = [k for k in before_vae if k.startswith("encoder.")]
    dec = [k for k in before_vae if k.startswith("decoder.")]
    same_enc = [k for k in enc if torch.equal(before_vae[k], after_vae[k])]
    same_dec = [k for k in dec if torch.equal(before_vae[k], after_vae[k])]
    said = (f"encoder {len(enc) - len(same_enc)}/{len(enc)}, decoder "
            f"{len(dec) - len(same_dec)}/{len(dec)}")
    assert not same_enc, same_enc[:5]
    if vae_trained:
        assert not same_dec, same_dec[:5]
    else:  # no gradient, so AdamW leaves it as loaded
        assert len(same_dec) == len(dec), "the export changed the decoder"
    report = dict(train_steps=n_train, val_batches=n_val, cli_wall_s=wall,
                  cli_peak_mem_bytes=cli_peak, launches=counts,
                  expected_launches=expect, history=history)
    if trainer == "train_full":
        before_head = torch.load(art["decoder"], weights_only=True)
        after_head = torch.load(out / "decoder" / "pytorch_model.bin",
                                weights_only=True)
        head_params = [n for n, _ in state.decoder.named_parameters()]
        same_head = [k for k in head_params
                     if torch.equal(before_head[k], after_head[k])]
        said += (f", head {len(head_params) - len(same_head)}/"
                 f"{len(head_params)}")
        assert not same_head, same_head[:5]
        thresholds = json.loads((out / "optimal_thresholds.json").read_text())
        overall = json.loads((out / "evaluation_results_overall.json")
                             .read_text())
        assert (out / "evaluation_results.csv").exists()
        assert len(thresholds["per_class_thresholds"]) == art["num_tags"]
        assert all(np.isfinite(v) for v in overall.values()), overall
        log(f"  final evaluation, {name}: global threshold "
            f"{thresholds['global_threshold']:.2f} (macro F1 "
            f"{thresholds['global_f1']:.4f}), mAP {overall['mAP']:.4f}")
        report.update(global_threshold=thresholds["global_threshold"],
                      global_f1=thresholds["global_f1"], mAP=overall["mAP"])
    if "--use_adaptive_weights" in flags:
        w = state.adaptive.log_weights.detach()
        log(f"  adaptive log weights after the epoch: {w.tolist()}")
        assert torch.isfinite(w).all() and w.abs().max().item() > 0, w
        report["adaptive_log_weights"] = w.tolist()
    log(f"  parameters changed, {name}: {said}")
    return state, out, report


def _steady_step(state, batch, dtype, iters, first_index, steps=None):
    """Mean host-clock time of ``iters`` train steps on one batch after one
    warm-up step, and the peak device memory over them; train_full's
    simplified-loss steps unless ``steps`` is given."""
    import torch
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.train.steps import FullSteps

    if steps is None:
        steps = FullSteps(LossConfig(triplet_weight=1.0,
                                     use_focal_loss=False),
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


@contextlib.contextmanager
def _f_ranges():
    """Every call of kernel F's wrapper (``normalization.
    group_norm_silu_backward``, whose callers look it up by name) inside a
    ``record_function`` range of its own, for the profiler; the port is
    not changed."""
    from torch.profiler import record_function
    from vae_tagger_tpu_torch.ops import normalization

    wrapper = normalization.group_norm_silu_backward

    def ranged(*args, **kwargs):
        with record_function(F_RANGE):
            return wrapper(*args, **kwargs)

    normalization.group_norm_silu_backward = ranged
    try:
        yield
    finally:
        normalization.group_norm_silu_backward = wrapper


# CUDA runtime and driver calls that put work on the device
DEVICE_WORK_CALLS = re.compile(r"^cu(da)?(Launch|Memcpy|Memset|GraphLaunch)")


def _f_range_kernels(prof):
    """[(kernel names, device us), ...] for each F range of a profile, in
    the order the ranges began: the device work (kernels, copies, memsets)
    launched while the range was open, found by time from the runtime's
    launch calls and joined to the device's records by correlation id (a
    launch through ctypes has no operator the profiler could link it to).
    A launch with no device record counts by the runtime call's name."""
    from torch.autograd import DeviceType

    events = prof.events()
    # (the device-side copy of a range, its GPU annotation, is no work)
    device = {e.id: e for e in events if e.device_type == DeviceType.CUDA
              and not _annotation(e)}
    calls = sorted((e for e in events if e.device_type == DeviceType.CPU
                    and DEVICE_WORK_CALLS.match(e.name)),
                   key=lambda e: e.time_range.start)
    ranges = sorted((e for e in events if e.name == F_RANGE
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    out = []
    for r in ranges:
        names, us = [], 0.0
        for call in calls:
            if not r.time_range.start <= call.time_range.start \
                    <= r.time_range.end:
                continue
            work = device.get(call.id)
            if work is None:
                names.append(call.name)
                continue
            m = re.search(r"\w+_kernel", work.name)
            names.append(m.group(0) if m else work.name[:60])
            us += work.time_range.elapsed_us()
        out.append((names, us))
    return out


def _f_records_missing(names):
    """Whether one F call's device work as profiled (_f_range_kernels)
    differs from F's two kernels only as a profile that lost device records
    can: at most two entries, each one of F's kernels or a launch call
    whose kernel went unrecorded.  An entry of any other kernel, or a third
    entry, is F's fault, never the profiler's."""
    return (sorted(names) != sorted(F_KERNELS)
            and len(names) <= len(F_KERNELS)
            and all(n in F_KERNELS or DEVICE_WORK_CALLS.match(n)
                    for n in names))


def _profiled_step(steps, state, batch, index, f_calls=None):
    """Device time of one profiled train step by kernel, the kernel calls
    by label, and the conv operators' calls (_conv_ops).  With
    ``f_calls``: the step calls kernel F's wrapper that often, and each
    call launches exactly F's two kernels and nothing else (no fold in
    torch, no copy of x or dAct)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_ATTEMPTS):
        ranges = _f_ranges() if f_calls else contextlib.nullcontext()
        with ranges, profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
            steps.train_step(state, batch, index + attempt)
            torch.cuda.synchronize()
        if not f_calls or not any(_f_records_missing(ks) for ks, _ in
                                  _f_range_kernels(prof)):
            break
        log("  the profile lost device records of kernel F: once more")
    by_kernel, top, calls = _kernel_breakdown(prof)
    convs = _conv_ops(prof)
    total_ms = sum(by_kernel.values())
    log(f"  one profiled step: {total_ms:.1f} ms of device time; conv "
        f"operators {convs}")
    f_ranges = None
    if f_calls:
        f_ranges = _f_range_kernels(prof)
        odd = [ks for ks, _ in f_ranges if sorted(ks) != sorted(F_KERNELS)]
        log(f"  kernel F: {len(f_ranges)} calls in the step, "
            f"{len(f_ranges) - len(odd)} of them exactly its two kernels")
        assert len(f_ranges) == f_calls and not odd, (len(f_ranges),
                                                      f_calls, odd[:3])
    for label, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        log(f"    {label}: {ms:.2f} ms ({calls[label]} kernels)")
    for ms, key in top:
        log(f"    top kernel {ms:.2f} ms: {key}")
    return dict(profiled_step_ms=total_ms, device_ms_by_kernel=by_kernel,
                kernel_calls=calls, top_kernels=top, conv_ops=convs,
                **({"f_calls_two_kernels": len(f_ranges)} if f_ranges
                   else {}))


def _forward_conv_ops(steps, state, batch):
    """The conv operators of the step's forward alone (an eval step: the
    same forward under no_grad), profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps.eval_step(state, batch, 0)
        torch.cuda.synchronize()
    return _conv_ops(prof)


@contextlib.contextmanager
def _recompute_backward():
    """The GroupNorm sites' backward as the port computed it before kernel
    F: the VJP of each op's plain version, recomputed eagerly under
    autograd (``vjp_of_plain``: a forward conv at every fused site, the
    fp32 GroupNorm chain and its autograd backward), in place of
    ``gn_silu_conv3x3_vjp`` and ``group_norm_silu_vjp``: the yardstick of
    the new backward, in the same process on the same card."""
    from vae_tagger_tpu_torch.ops import conv, normalization

    def gn_vjp(g, x, mean, meansq, scale, bias, *, eps, apply_silu=True,
               es=None, eb=None, stats_term=True):
        if stats_term:
            def plain(x, scale, bias):
                return normalization.group_norm_silu_reference(
                    x, scale, bias, num_groups=mean.shape[-1], eps=eps,
                    apply_silu=apply_silu)

            dx, dscale, dbias = normalization.vjp_of_plain(
                plain, (x, scale, bias), g)
            return dx, None, None, dscale, dbias

        def plain(*ts):
            return normalization.group_norm_silu_from_stats_plain(
                *ts, eps=eps, apply_silu=apply_silu)

        return normalization.vjp_of_plain(plain, (x, mean, meansq, scale,
                                                  bias), g)

    def conv_vjp(g, x, *tensors, mean, meansq, es=None, eb=None, eps=1e-6,
                 stats_term=True):
        tensors = list(tensors) + [None] * (7 - len(tensors))
        if stats_term:
            def plain(*ts):
                return conv.gn_silu_conv3x3_plain(
                    *ts, num_groups=mean.shape[-1], eps=eps)

            grads = normalization.vjp_of_plain(plain, [x, *tensors], g)
            return (grads[0], None, None) + grads[1:]

        def plain(*ts):
            return conv.gn_silu_conv3x3_from_stats_plain(*ts, eps=eps)

        return normalization.vjp_of_plain(plain, [x, mean, meansq, *tensors],
                                          g)

    saved = (conv.gn_silu_conv3x3_vjp, normalization.group_norm_silu_vjp)
    conv.gn_silu_conv3x3_vjp = conv_vjp
    normalization.group_norm_silu_vjp = gn_vjp
    try:
        yield
    finally:
        conv.gn_silu_conv3x3_vjp, normalization.group_norm_silu_vjp = saved


def _step_before_after(state, batch, dtype, iters, first_index, steps=None,
                       check_convs=False, per_step=None):
    """The steady step (``_steady_step``: host clock over ``iters`` steps,
    peak memory) and one profiled step by kernel, first with the backward
    of kernel F, then with the recompute it replaced
    (``_recompute_backward``), on the same state and batch.  With
    ``check_convs``: the profiled step runs cuDNN's forward convolution
    exactly as often as the step's forward alone (an eval step), so no
    fused site runs a forward conv in the backward; the recompute's step
    runs one more a fused site.  The profiled step with kernel F calls it
    as often as ``per_step`` (TRAIN_STEP_LAUNCHES by default) counts, each
    call exactly F's two kernels (_profiled_step)."""
    import torch

    key = "bf16" if dtype == torch.bfloat16 else "fp32"
    f_calls = (per_step or TRAIN_STEP_LAUNCHES)[key]["group_norm_silu_bwd"]
    out = {}
    for when in ("after", "before"):
        ctx = (_recompute_backward() if when == "before"
               else contextlib.nullcontext())
        with ctx:
            step_s, peak, steps = _steady_step(state, batch, dtype, iters,
                                               first_index, steps)
            log(f"  steady step, {key}, {when} (backward "
                f"{'of kernel F' if when == 'after' else 'recomputed'}): "
                f"{step_s * 1e3:.1f} ms, {TRAIN_ROWS / step_s:.3f} images/s "
                f"(host clock, {iters} steps), peak device memory "
                f"{peak / 2**30:.2f} GiB")
            prof = _profiled_step(steps, state, batch,
                                  first_index + 1000 + iters,
                                  f_calls if when == "after" else None)
        out[when] = dict(prof, step_s=step_s, step_peak_mem_bytes=peak)
        first_index += 2 * iters + 2
    if check_convs:
        fwd = _forward_conv_ops(steps, state, batch)
        fused = sum(n for k, n in ENCODE_LAUNCHES[key].items()
                    if k.startswith("gn_silu"))
        after = out["after"]["conv_ops"]["aten::cudnn_convolution"]
        before = out["before"]["conv_ops"]["aten::cudnn_convolution"]
        log(f"  cuDNN forward convolutions: {after} in a step's forward and "
            f"backward, {fwd['aten::cudnn_convolution']} in its forward "
            f"alone; {before} with the recompute ({fused} fused sites)")
        assert after == fwd["aten::cudnn_convolution"] > 0, (after, fwd)
        assert before == after + fused, (before, after, fused)
        out["forward_conv_ops"] = fwd
    return dict(out["after"], before=out["before"], steps=steps,
                **({"forward_conv_ops": out["forward_conv_ops"]}
                   if check_convs else {}))


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
    json_path = _write_training_data(art)
    state, out, rep16 = _train_cli(art, json_path, "bf16")

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

    # steady bf16 step time on one batch and one profiled step, with the
    # backward of kernel F and then with the recompute it replaced; no
    # forward conv of a fused site may run in the backward
    step16 = _step_before_after(state, batch, torch.bfloat16, 10, 1000,
                                check_convs=True)
    step_s = step16["step_s"]
    del state, step16["steps"]
    torch.cuda.empty_cache()

    # fp32 (--mixed_precision no): D'' and E'' carry the attention backward
    state32, _, rep32 = _train_cli(art, json_path, "no")
    step32 = _step_before_after(state32, batch, torch.float32, 4, 3000,
                                check_convs=True)
    step32_s, steps32 = step32["step_s"], step32.pop("steps")
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
    want = _plus(ENCODE_LAUNCHES["fp32"],
                 _gn_backward_launches(ENCODE_LAUNCHES["fp32"]),
                 dict(flash_attention_bwd_dq=1, flash_attention_bwd_dkv=1))
    assert counts_simt == _expected(want, iters_simt), counts_simt
    log(f"  steady train step, fp32 with the SIMT D and E: "
        f"{step32_simt_s * 1e3:.1f} ms (host clock, {iters_simt} steps); "
        f"with D'' and E'': {step32_s * 1e3:.1f} ms")
    del state32, steps32
    torch.cuda.empty_cache()

    gate = _gradient_gate(art, batch)
    report = dict(rep16, step_s_bf16=step_s,
                  images_per_s_bf16=TRAIN_ROWS / step_s, step_bf16=step16,
                  fp32=dict(rep32, step_s=step32_s,
                            images_per_s=TRAIN_ROWS / step32_s,
                            step_s_simt_d_e=step32_simt_s, step=step32),
                  gradient_gate=gate)
    return report, art, json_path, out, batch


def phase_decode_gate(art):
    """One decode of a 1024px latent (batch 1) through
    ``AutoencoderKL.decode``, the seeded full-width VAE with its decoder:
    the exact launches (A 2, stats 28, B 28, C 1), the fp32 kernel path
    against the plain fp32 path (MSE < 1e-10, the encoder's gate), the
    bf16 kernel path against the plain fp32 path within 4x the plain bf16
    path's own MSE; the decode's time in both dtypes (CUDA events)."""
    import torch
    from vae_tagger_tpu_torch.io.checkpoints import load_vae
    from vae_tagger_tpu_torch.ops import backend

    log(f"decode gate: AutoencoderKL.decode of one {RES}px latent, fp32 and "
        f"bf16, kernel path against the plain path")
    vae = load_vae(art["vae"], art["config"], with_decoder=True).to(DEVICE).eval()
    z = torch.randn(1, RES // 8, RES // 8, 16,
                    generator=torch.Generator().manual_seed(SEED + 6)).to(DEVICE)
    out, recs = {}, {}
    with torch.inference_mode():
        for key, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            torch.cuda.synchronize()
            backend.reset_launch_counts()
            recs[key] = vae.decode(z, dt)
            torch.cuda.synchronize()
            counts = backend.launch_counts()
            assert counts == _expected(DECODE_LAUNCHES[key], 1), counts
            out[f"launches_{key}"] = counts
            out[f"ms_{key}"] = time_ms(lambda dt=dt: vae.decode(z, dt))
        with backend.backend("torch"):
            ref = vae.decode(z)
            ref16 = vae.decode(z, torch.bfloat16)
            out["plain_ms_fp32"] = time_ms(lambda: vae.decode(z))
    assert recs["fp32"].shape == (1, RES, RES, 3)
    mse = ((recs["fp32"] - ref) ** 2).mean().item()
    mse16 = ((recs["bf16"] - ref) ** 2).mean().item()
    mse16_t = ((ref16 - ref) ** 2).mean().item()
    log(f"  decode fp32: kernel vs plain MSE {mse:.3e} (gate 1e-10); bf16 "
        f"kernel vs fp32 plain {mse16:.3e}, plain bf16's own {mse16_t:.3e} "
        f"(gate 4x); {out['ms_fp32']:.2f} ms fp32 (plain "
        f"{out['plain_ms_fp32']:.2f}), {out['ms_bf16']:.2f} ms bf16 a "
        f"decode")
    assert all(torch.isfinite(r).all() for r in recs.values())
    assert mse < 1e-10 and mse16 <= 4 * mse16_t, (mse, mse16, mse16_t)
    del vae, recs, ref, ref16
    torch.cuda.empty_cache()
    return dict(out, mse_fp32_kernel_vs_plain=mse,
                mse_bf16_kernel_vs_fp32_plain=mse16,
                mse_bf16_plain_vs_fp32_plain=mse16_t)


def _vae_gradient_gate(art, batch):
    """One fp32 train_vae batch with the KL optimized, the same weights
    and generators, through the kernel path and the torch backend: the
    loss, and every parameter's gradient, encoder and decoder, within 1e-3
    relative, or absolute where the torch path's norm is below
    ZERO_GRAD_NORM (as _gradient_gate); exact launches of the kernel
    path."""
    import torch
    from vae_tagger_tpu_torch.io.checkpoints import load_vae
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.train.state import TrainState
    from vae_tagger_tpu_torch.train.steps import (
        VaeSteps,
        batch_to_device,
        step_generators,
    )

    dev = torch.device(DEVICE)
    vae = load_vae(art["vae"], art["config"], with_decoder=True).to(dev)
    state = TrainState(vae=vae, decoder=None, optimizer=None)
    steps = VaeSteps(LossConfig(reconstruction_weight=0.01, kl_weight=1e-2,
                                triplet_weight=1.0), use_simplified=False,
                     compute_dtype=torch.float32, seed=SEED)
    dev_batch = batch_to_device(batch, dev)
    params = list(vae.named_parameters())
    grads, losses = {}, {}
    for be in ("kernel", "torch"):
        vae.zero_grad(set_to_none=True)
        backend.reset_launch_counts()
        g, g_recon = step_generators(dev, SEED, 7)
        with backend.backend(be):
            total, _, _ = steps.forward_losses(state, dev_batch, g,
                                               train=True,
                                               recon_generator=g_recon)
            total.backward()
        torch.cuda.synchronize()
        if be == "kernel":
            launches = backend.launch_counts()
            expect = _expected(VAE_STEP_LAUNCHES["fp32"], 1)
            assert launches == expect, (launches, expect)
        losses[be] = total.item()
        missing = [n for n, p in params if p.grad is None]
        assert not missing, f"{be} path: no gradient for {missing[:5]}"
        grads[be] = {n: p.grad.detach().clone() for n, p in params}
    worst, errs, absolute = ("", 0.0, 0.0), [], {}
    for n, _ in params:
        gt, gk = grads["torch"][n], grads["kernel"][n]
        diff, norm = (gk - gt).norm().item(), gt.norm().item()
        err = diff if norm < ZERO_GRAD_NORM else diff / norm
        if norm < ZERO_GRAD_NORM:
            absolute[n] = (norm, diff)
        errs.append(err)
        if err >= worst[1]:
            worst = (n, err, norm)
    log(f"  train_vae gradient gate (fp32, {len(params)} parameters, "
        f"{sum(n.startswith('decoder.') for n, _ in params)} of the "
        f"decoder): loss kernel {losses['kernel']:.6f} vs torch "
        f"{losses['torch']:.6f}; worst {worst[0]} {worst[1]:.3e} (torch-path "
        f"norm {worst[2]:.3e}; gate 1e-3); median "
        f"{sorted(errs)[len(errs) // 2]:.3e}; compared absolutely: "
        f"{ {k: f'{a:.2e}/{b:.2e}' for k, (a, b) in absolute.items()} }")
    assert all(e <= 1e-3 for e in errs), worst
    assert abs(losses["kernel"] - losses["torch"]) <= 1e-4 * abs(
        losses["torch"]), losses
    del grads, state, vae
    torch.cuda.empty_cache()
    return dict(parameters=len(params), launches=launches,
                expected_launches=expect, worst_param=worst[0],
                worst_err=worst[1], worst_param_grad_norm=worst[2],
                median_err=sorted(errs)[len(errs) // 2], losses=losses,
                compared_absolutely={k: dict(torch_norm=a, diff_norm=b)
                                     for k, (a, b) in absolute.items()})


# train_vae's loss in phase_train_vae and _tree_steps
VAE_LOSS = dict(reconstruction_weight=0.01, kl_weight=1e-2, triplet_weight=1.0)


def phase_train_vae(art, json_path, batch):
    """``python -m vae_tagger_tpu_torch.train.train_vae`` for one epoch
    at 1024px, batch 1, in bf16 and then in fp32 (``--mixed_precision
    no``), each checked by _train_cli (exact launches: per step A 4, stats
    48, B 48, C 2, D 2, E 4); the bf16 export reloads and decodes; steady
    step time, images/s and peak memory, and one profiled step by kernel,
    in both dtypes; then the fp32 gradient gate over every parameter."""
    import torch
    from vae_tagger_tpu_torch.io.checkpoints import load_vae
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.train.steps import VaeSteps

    log(f"train_vae path: python -m vae_tagger_tpu_torch.train.train_vae, "
        f"full FLUX VAE with its decoder, {N_IMAGES} seeded {RES}px images, "
        f"batch 1 (B={TRAIN_ROWS} stacked encode, the anchor decoded), "
        f"bf16, then fp32")
    cfg = LossConfig(**VAE_LOSS)
    report = {}
    for precision, dt, iters in (("bf16", torch.bfloat16, 5),
                                 ("no", torch.float32, 3)):
        key = "bf16" if precision == "bf16" else "fp32"
        state, out, rep = _train_cli(art, json_path, precision, "train_vae")
        if key == "bf16":
            vae = load_vae(str(out / "vae" /
                               "diffusion_pytorch_model.safetensors"),
                           str(out / "vae" / "config.json"),
                           with_decoder=True).to(DEVICE).eval()
            z = torch.randn(1, RES // 8, RES // 8, 16, device=DEVICE)
            with torch.inference_mode():
                rec = vae.decode(z, torch.bfloat16)
            assert rec.shape == (1, RES, RES, 3) and torch.isfinite(
                rec).all()
            log("  the bf16 export reloads with its decoder and decodes")
            del vae, rec
        # TRAIN_ROWS encoded and 1 decoded a step
        step = _step_before_after(state, batch, dt, iters,
                                  6000 + 1000 * iters,
                                  VaeSteps(cfg, compute_dtype=dt, seed=SEED),
                                  per_step=VAE_STEP_LAUNCHES)
        del step["steps"]
        report[key] = dict(rep, step_s=step["step_s"],
                           images_per_s=TRAIN_ROWS / step["step_s"],
                           step=step)
        del state
        torch.cuda.empty_cache()
    report["gradient_gate"] = _vae_gradient_gate(art, batch)
    return report


def phase_full_loss(art, json_path):
    """``train_full --no_simplified_loss --use_adaptive_weights`` for one
    epoch in bf16 (checked by _train_cli: exact launches, finite losses,
    the decoder trained, the adaptive weights moved, the final phase's
    files), with its steady step time."""
    import torch

    log("full-loss train_full: --no_simplified_loss --use_adaptive_weights, "
        "one epoch in bf16, then the final threshold search and evaluation")
    state, out, rep = _train_cli(
        art, json_path, "bf16", "train_full",
        ("--no_simplified_loss", "--use_adaptive_weights"))
    del state
    torch.cuda.empty_cache()
    return rep, out


def phase_eval_and_latents(art, json_path, train_out):
    """``python -m vae_tagger_tpu_torch.eval`` on train_full's bf16
    exports over the 8 images (default fp32, batch 4), and ``python -m
    vae_tagger_tpu_torch.infer.latents`` on them (fp32, npz): exact
    launches (two encode batches each), the evaluation's files, and the
    latents against the engine's encode_scaled mode on the plain path
    (MSE < 1e-10, the fp32 gate)."""
    import numpy as np
    import torch
    from vae_tagger_tpu_torch.eval.__main__ import main as eval_main
    from vae_tagger_tpu_torch.infer.engine import VAEOnlyEngine
    from vae_tagger_tpu_torch.infer.latents import (
        flatten_latent_torch_order,
    )
    from vae_tagger_tpu_torch.infer.latents import main as latents_main
    from vae_tagger_tpu_torch.infer.pipeline import iter_image_batches
    from vae_tagger_tpu_torch.data.paths import get_image_paths
    from vae_tagger_tpu_torch.ops import backend

    log("evaluation and latent extraction: python -m "
        "vae_tagger_tpu_torch.eval and python -m "
        "vae_tagger_tpu_torch.infer.latents, fp32, batch 4")
    n_batches = -(-N_IMAGES // BATCH)
    out = {}
    eval_dir = WORK / "eval_out"
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    mets = eval_main([
        "--vae_checkpoint",
        str(train_out / "best_vae" / "diffusion_pytorch_model.safetensors"),
        "--vae_config_path", str(train_out / "best_vae" / "config.json"),
        "--decoder_checkpoint",
        str(train_out / "best_decoder" / "pytorch_model.bin"),
        "--json_path", json_path, "--tags_csv_path", art["tags"],
        "--output_dir", str(eval_dir), "--resolution", str(RES),
        "--batch_size", str(BATCH), "--num_workers", "4",
        "--device", DEVICE])
    torch.cuda.synchronize()
    counts = backend.launch_counts()
    assert counts == _expected(ENCODE_LAUNCHES["fp32"], n_batches), counts
    for f in ("optimal_thresholds.json", "evaluation_results.csv",
              "evaluation_results_overall.json"):
        assert (eval_dir / f).exists(), f
    assert np.isfinite(mets["f1_macro"]) and np.isfinite(mets["mAP"])
    log(f"  eval CLI: {time.perf_counter() - t0:.2f} s, macro F1 "
        f"{mets['f1_macro']:.4f} at threshold {mets['threshold']:.2f}, mAP "
        f"{mets['mAP']:.4f}; launches {counts}")
    out["eval"] = dict(launches=counts, f1_macro=mets["f1_macro"],
                       mAP=mets["mAP"], threshold=mets["threshold"])

    backend.reset_launch_counts()
    t0 = time.perf_counter()
    got = latents_main([
        "--vae_checkpoint", art["vae"], "--vae_config_path", art["config"],
        "--image_path", art["images"], "--output_dir",
        str(WORK / "latents_out"), "--resolution", str(RES),
        "--batch_size", str(BATCH), "--num_workers", "4",
        "--output_format", "npz", "--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = backend.launch_counts()
    assert counts == _expected(ENCODE_LAUNCHES["fp32"], n_batches), counts
    on_disk = dict(np.load(WORK / "latents_out" / "latent_vectors.npz"))
    paths = [str(p) for p in get_image_paths(art["images"])]
    assert sorted(on_disk) == sorted(got) == sorted(paths)
    eng = VAEOnlyEngine.load(art["vae"], art["config"], device=DEVICE)
    assert eng.vae.decoder is None
    errs = []
    with backend.backend("torch"):
        for _, batch_paths, block in iter_image_batches(paths, RES, BATCH,
                                                        4, 1):
            for p, z in zip(batch_paths, eng.encode(block)):
                ref = flatten_latent_torch_order(z)
                errs.append(float(np.mean((on_disk[p] - ref) ** 2)))
    log(f"  latents CLI: {N_IMAGES} images in {wall:.2f} s; latents vs the "
        f"engine's plain-path encode_scaled mode: worst MSE {max(errs):.3e} "
        f"(gate 1e-10); launches {counts}")
    assert len(errs) == N_IMAGES and max(errs) < 1e-10, errs
    del eng
    torch.cuda.empty_cache()
    out["latents"] = dict(launches=counts, wall_s=wall,
                          worst_mse_vs_plain=max(errs))
    return out


# --------------------------------------------------------------------------
# the tiled VAE, train_decoder with --cache_latents, aspect-ratio
# buckets and the YUV 4:2:0 wire format
# --------------------------------------------------------------------------

# tiles a call of the tiled VAE (its default)
TILE_BATCH = 8
# the decoder's first fused conv of its 1024^2 stage and that block's
# shortcut, at a tile batch: x (or the residual) holds 8 * 1024^2 * 256 =
# 2^31 elements; (N, H, W, Cin, Cout, variant, Cres)
TILED_B_CASES = [(TILE_BATCH, 1024, 1024, 256, 128, "plain", None),
                 (TILE_BATCH, 1024, 1024, 128, 128, "shortcut", 256)]
# the 704x576 bucket: the encoder's first ResnetBlock conv at a stacked
# triplet (B=3), and the mid-block attention's S = 88 * 72 = 6,336, no
# multiple of 128
BUCKET = (704, 576)
BUCKET_B_CASE = (TRAIN_ROWS, BUCKET[1], BUCKET[0], 128, 128, "residual", 128)
RAGGED_S = (BUCKET[0] // 8) * (BUCKET[1] // 8)
# the tiled VAE's image: 2048 x 1536 at tile 1024, overlap 256 is 2 x 3 =
# 6 tiles, one tile batch
TILED_W, TILED_H, TILE, OVERLAP = 2048, 1536, 1024, 256
# the bucketed dataset: (w, h) -> the bucket the JAX package assigns
BUCKET_IMAGES = {(1408, 1152): (704, 576), (1024, 768): (768, 576),
                 (1024, 1024): (512, 512)}
# the JAX package's chroma bound on tag probabilities, RGB against YUV
# 4:2:0 on the same images (tests/test_yuv.py, the loader/classify test)
YUV_PROB_BOUND = 0.05


def _rnd_dev(g, *shape, scale=1.0, shift=0.0):
    """Seeded normal tensor made on the card (``g`` a CUDA generator),
    rounded to bf16-representable fp32 values: the 2^31-element inputs
    would take seconds to draw on the host."""
    import torch

    t = torch.randn(*shape, generator=g, device=DEVICE)
    return (t.mul_(scale).add_(shift)).bfloat16().float()


def _tile_bucket(results, name, label, chk, key="tile_bucket", **timed):
    """One case of the tile and bucket shapes (or, with ``key``, of another
    set of shapes) under its kernel's ``key`` report: the worst errors of
    ``chk`` (a check of this case alone) and the times."""
    worst = {k: max(r[k] for r in chk.rows if k in r)
             for k in ("rel_err_fp32", "rel_err_bf16", "abs_err_fp32",
                       "abs_err_bf16") if any(k in r for r in chk.rows)}
    results[name].setdefault(key, {})[label] = dict(worst, **timed)


def phase_tile_bucket_kernels(results):
    """The kernels at the shapes that the tiled VAE and the buckets give
    them, each
    against its plain version in the dtypes it runs, timed beside it and
    the library call:

    - a tile batch of 8 at 1024^2: B' and B'' at the decoder's 256->128
      conv (x of 2^31 elements) and the 1x1 shortcut from 256 channels (a
      residual of 2^31 elements), the stats pass and A on the 2^31-element
      activation, in both dtypes;
    - the 704x576 bucket: B' and B'' at the encoder's first ResnetBlock
      conv at B=3 (W != H); C', C'', D', E', D'' and E'' at B=3,
      S=6,336, D=512 (S no multiple of 128);
    - C' and C'' at B=8, S=16,384 (a tile batch's mid-block)."""
    import torch
    import torch.nn.functional as F
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.attention import (
        bwd_delta,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )
    from vae_tagger_tpu_torch.ops.conv import gn_silu_conv3x3
    from vae_tagger_tpu_torch.ops.normalization import (
        group_norm_affine,
        group_norm_silu,
    )

    log("the tile and bucket shapes: a tile batch of 8 at 1024^2 (2^31-element "
        "activations), the 704x576 bucket (W != H, S=6,336) and C at B=8, "
        "S=16,384")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    conv_dts = {"gn_silu_conv3x3_tc": torch.bfloat16,
                "gn_silu_conv3x3_tf32x3": torch.float32}
    for n, h, w, cin, cout, variant, cres in (TILED_B_CASES
                                              + [BUCKET_B_CASE]):
        x = _rnd_dev(g, n, h, w, cin)
        gs = _rnd_dev(g, cin, scale=0.2, shift=1.0)
        gb = _rnd_dev(g, cin, scale=0.1)
        k = _rnd_dev(g, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        b = _rnd_dev(g, cout, scale=0.1)
        res = _rnd_dev(g, n, h, w, cres) if cres else None
        sck = (_rnd_dev(g, cres, cout, scale=cres ** -0.5)
               if variant == "shortcut" else None)
        scb = _rnd_dev(g, cout, scale=0.1) if variant == "shortcut" else None
        xs, rs = _both(x), _both(res)
        del x, res
        label = (f"N={n} {h}x{w} {cin}->{cout} {variant}"
                 + (f" Cres={cres}" if variant == "shortcut" else ""))
        big = max(n * h * w * cin, n * h * w * (cres or 0))
        log(f"  {label}: largest input {big} elements "
            f"({'2^31' if big == 2 ** 31 else 'under 2^31'})")

        def op(dt):
            return gn_silu_conv3x3(xs[dt], gs, gb, k, b, rs[dt], sck, scb,
                                   num_groups=GROUPS)

        m = n * h * w
        k_dim = 9 * cin + (cres if variant == "shortcut" else 0)
        for name, dt in conv_dts.items():
            chk = Check(name, ("bf16",) if dt == torch.bfloat16 else
                        ("fp32",))
            chk.run(label, op)
            w_oihw = k.to(dt).permute(3, 2, 0, 1).contiguous()
            sc_oihw = (None if sck is None
                       else sck.to(dt).t()[:, :, None, None].contiguous())

            def library(dt=dt, w_oihw=w_oihw, sc_oihw=sc_oihw):
                y = F.silu(F.group_norm(xs[dt].permute(0, 3, 1, 2), GROUPS,
                                        gs.to(dt), gb.to(dt), 1e-6))
                out = F.conv2d(y, w_oihw, b.to(dt), padding=1)
                if sc_oihw is not None:
                    out = out + F.conv2d(rs[dt].permute(0, 3, 1, 2), sc_oihw,
                                         scb.to(dt))
                elif rs[dt] is not None:
                    out = out + rs[dt].permute(0, 3, 1, 2)
                return out

            ms, plain_ms, lib_ms = time_kernel(op, dt, library)
            esize = 2.0 if dt == torch.bfloat16 else 4.0
            flops = 2.0 * m * k_dim * cout
            nbytes = esize * (m * cin + m * cout + (m * cres if cres else 0)
                              + k_dim * cout)
            b_ms, b_by = (bound(nbytes, flops) if dt == torch.bfloat16
                          else _fp32_bounds(nbytes, flops)[1])
            log(f"  {name} {label}: {ms:.3f} ms (bound {b_ms:.3f}, "
                f"{b_ms / ms:.1%}, {b_by}), plain {plain_ms:.3f}, cuDNN "
                f"{lib_ms:.3f}")
            _tile_bucket(results, name, label, chk, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                    launches_per_call=1)
            torch.cuda.empty_cache()
        # the stats pass and A on the 2^31-element activation (x of the
        # decoder's 256->128 conv)
        big_t, c_big = xs, cin
        if variant == "plain" and n == TILE_BATCH:
            gsb = _rnd_dev(g, c_big, scale=0.2, shift=1.0)
            gbb = _rnd_dev(g, c_big, scale=0.1)
            for name in ("group_stats", "group_norm_silu"):
                chk = Check(name)
                a_label = f"N={n} {h}x{w} C={c_big}"

                def gop(dt, name=name):
                    if name == "group_stats":
                        return group_norm_affine(big_t[dt], gsb, gbb,
                                                 num_groups=GROUPS)
                    return group_norm_silu(big_t[dt], gsb, gbb,
                                           num_groups=GROUPS)

                chk.run(a_label, gop)
                for dt in (torch.bfloat16, torch.float32):
                    xd = big_t[dt]
                    nbytes = xd.numel() * xd.element_size() * (
                        1 if name == "group_stats" else 2)

                    def library(xd=xd, dt=dt, name=name):
                        if name == "group_stats":
                            return torch.var_mean(
                                xd.view(n, h * w, GROUPS, -1).float(),
                                dim=(1, 3), correction=0)
                        return F.silu(F.group_norm(
                            xd.permute(0, 3, 1, 2), GROUPS, gsb.to(dt),
                            gbb.to(dt), 1e-6))

                    ms, plain_ms, lib_ms = time_kernel(gop, dt, library)
                    b_ms = nbytes / PEAK_BYTES * 1e3
                    key = str(dt).removeprefix("torch.")
                    log(f"  {name} {a_label} {key}: {ms:.3f} ms (bound "
                        f"{b_ms:.3f}, {b_ms / ms:.0%}), plain "
                        f"{plain_ms:.3f}, library {lib_ms:.3f}")
                    _tile_bucket(results, name, f"{a_label} {key}", chk, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by="bytes",
                            launches_per_call=(1 if name == "group_stats"
                                               else 2))
                    torch.cuda.empty_cache()
        del xs, rs, big_t
        torch.cuda.empty_cache()

    # attention: the bucket's ragged S forward and backward, the tile
    # batch's forward
    d = 512
    fwd = {"flash_attention_fwd_tc": torch.bfloat16,
           "flash_attention_fwd_tf32x3": torch.float32}
    bwd = {"flash_attention_bwd_dq_tc": ("dq", torch.bfloat16),
           "flash_attention_bwd_dkv_tc": ("dkv", torch.bfloat16),
           "flash_attention_bwd_dq_tf32x3": ("dq", torch.float32),
           "flash_attention_bwd_dkv_tf32x3": ("dkv", torch.float32)}
    parts = {"dq": flash_attention_bwd_dq, "dkv": flash_attention_bwd_dkv}
    for b, s, with_bwd in ((TRAIN_ROWS, RAGGED_S, True),
                           (TILE_BATCH, (RES // 8) ** 2, False)):
        q, k, v, do = (_rnd_dev(g, b, s, d) for _ in range(4))
        ins = {dt: tuple(t.to(dt) for t in (q, k, v, do))
               for dt in (torch.float32, torch.bfloat16)}
        label = f"B={b} S={s}"
        for name, dt in fwd.items():
            chk = Check(name, ("bf16",) if dt == torch.bfloat16 else
                        ("fp32",))

            def op(dt_):
                return flash_attention_fwd(*ins[dt_][:3])

            chk.run(label, op)
            esize = 2.0 if dt == torch.bfloat16 else 4.0
            ms, plain_ms, lib_ms = time_kernel(
                op, dt, lambda dt=dt: sdpa(*ins[dt][:3]))
            nbytes = esize * 4 * b * s * d + 4.0 * b * s
            flops = 4.0 * b * s * s * d
            b_ms, b_by = (bound(nbytes, flops) if dt == torch.bfloat16
                          else _fp32_bounds(nbytes, flops)[1])
            log(f"  {name} {label}: {ms:.3f} ms (bound {b_ms:.3f}, "
                f"{b_ms / ms:.1%}), plain {plain_ms:.3f}, SDPA {lib_ms:.3f}")
            _tile_bucket(results, name, label, chk, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                    launches_per_call=1)
        if with_bwd:
            with backend.backend("torch"):
                o, lse = flash_attention_fwd(q, k, v)
            delta = bwd_delta(o, do)
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
            for name, (part, dt) in bwd.items():
                chk = Check(name, ("bf16",) if dt == torch.bfloat16 else
                            ("fp32",))

                def call(dt_, part=part):
                    out = parts[part](*ins[dt_], lse, delta)
                    return out if isinstance(out, tuple) else (out,)

                chk.run(label, call)
                ms, plain_ms, _ = time_kernel(call, dt)
                esize = 2.0 if dt == torch.bfloat16 else 4.0
                nbytes = (esize * 4 * b * s * d + 4.0 * 2 * b * s
                          + esize * (1 if part == "dq" else 2) * b * s * d)
                flops = (6.0 if part == "dq" else 8.0) * b * s * s * d
                b_ms, b_by = (bound(nbytes, flops) if dt == torch.bfloat16
                              else _fp32_bounds(nbytes, flops)[1])
                log(f"  {name} {label}: {ms:.3f} ms (bound {b_ms:.3f}, "
                    f"{b_ms / ms:.1%}), plain {plain_ms:.3f}; SDPA's whole "
                    f"backward {lib_ms[dt]:.3f}")
                _tile_bucket(results, name, label, chk, ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms[dt], bound_ms=b_ms, bound_by=b_by,
                        launches_per_call=2 if part == "dkv" else 1)
            del o, lse, delta
        del q, k, v, do, ins
        torch.cuda.empty_cache()


def _seeded_png(path, w, h, seed):
    """A seeded smooth-plus-noise RGB image of w x h, saved as PNG."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(w, h)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    freq = rng.uniform(2, 12, size=3)
    img = np.stack([np.sin(freq[c] * (xx + yy * (c + 1)) * np.pi + phase[c])
                    for c in range(3)], -1) * 100 + 128
    img += rng.normal(0, 20, size=img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    Image.fromarray(img).save(path)
    return img


def _photo_png(path, w, h, seed):
    """A seeded photo-like RGB image (smooth content, noise of sigma 3: the
    JAX package's YUV test image, tests/test_yuv.py), saved as PNG."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, size=3)
    base = np.stack([128 + 100 * np.sin(xx / 9.0 + ph[0]) * np.cos(yy / 13.0),
                     128 + 90 * np.cos(xx / 17.0 + ph[1]),
                     128 + 80 * np.sin((xx + yy) / 11.0 + ph[2])], axis=-1)
    img = np.clip(base + rng.normal(0, 3, size=(h, w, 3)), 0, 255)
    Image.fromarray(img.astype(np.uint8)).save(path)


def _mse(a, b):
    import numpy as np

    return float(np.mean((np.asarray(a, np.float64)
                          - np.asarray(b, np.float64)) ** 2))


def phase_tiled(art):
    """The tiled VAE on a seeded 2048x1536 image (tile 1024, overlap 256:
    six tiles, one batch of 8 for the encode and one for the decode),
    through ``TiledVAE`` on the seeded full-width VAE:

    - the exact launches of one tile batch (encode A 2, stats 20, B 20,
      C 1; decode A 2, stats 28, B 28, C 1), wall time and peak device
      memory of the encode and the decode, fp32 and bf16;
    - fp32: the kernel path against the plain path on the same tiles,
      latents MSE < 1e-10 and pixels (decoding the same latents) MSE <
      1e-10; bf16: the kernel path against the plain fp32 path within 4x
      the plain bf16 path's own MSE;
    - a seeded 1024^2 image (one tile) against ``VAEOnlyEngine.encode``:
      MSE < 1e-10 in fp32;
    - ``python -m vae_tagger_tpu_torch.infer.latents --tiled`` and
      ``python -m vae_tagger_tpu_torch.infer.reconstruct --tiled`` on the
      2048x1536 image: the latents equal the tiled encode's, and the
      reconstruction prints a finite PSNR."""
    import numpy as np
    import torch
    from vae_tagger_tpu_torch.core.precision import FP32
    from vae_tagger_tpu_torch.infer.engine import VAEOnlyEngine
    from vae_tagger_tpu_torch.infer.latents import (
        flatten_latent_torch_order,
    )
    from vae_tagger_tpu_torch.infer.latents import main as latents_main
    from vae_tagger_tpu_torch.infer.reconstruct import main as recon_main
    from vae_tagger_tpu_torch.infer.tiled import TiledVAE
    from vae_tagger_tpu_torch.io.checkpoints import load_vae
    from vae_tagger_tpu_torch.ops import backend

    from vae_tagger_tpu_torch.infer.tiled import tile_starts

    rows, cols = (len(tile_starts(n, TILE, TILE - OVERLAP))
                  for n in (TILED_H, TILED_W))
    log(f"tiled VAE: a seeded {TILED_W}x{TILED_H} image, tile {TILE}, "
        f"overlap {OVERLAP} ({rows} x {cols} = {rows * cols} tiles, one "
        f"batch of {TILE_BATCH}), fp32 and bf16, kernel path against the "
        f"plain path")
    assert rows * cols <= TILE_BATCH
    d = WORK / "tiled"
    d.mkdir(parents=True, exist_ok=True)
    img = _seeded_png(d / "big.png", TILED_W, TILED_H, SEED + 20)
    vae = load_vae(art["vae"], art["config"], with_decoder=True).to(
        DEVICE).eval()
    out = {}
    z, px = {}, {}
    for key, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        tiler = TiledVAE(vae, TILE, OVERLAP, TILE_BATCH, dt)
        for what, fn, expect in (
                ("encode", lambda: tiler.encode(img), ENCODE_LAUNCHES[key]),
                ("decode", lambda: tiler.decode(z["fp32"]),
                 DECODE_LAUNCHES[key])):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            backend.reset_launch_counts()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = backend.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            assert counts == _expected(expect, 1), (key, what, counts)
            assert np.isfinite(res).all(), (key, what)
            (z if what == "encode" else px)[key] = res
            # a second call, warm
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            out[f"{what}_{key}"] = dict(launches=counts, wall_s=wall,
                                        warm_wall_s=warm,
                                        peak_mem_bytes=peak)
            log(f"  tiled {what}, {key}: {wall:.3f} s cold, {warm:.3f} s "
                f"warm (one tile batch of {TILE_BATCH}, host blend "
                f"included), peak device memory {peak / 2**30:.2f} GiB; "
                f"launches {({k: c for k, c in counts.items() if c})}")
    with backend.backend("torch"):
        pz32 = TiledVAE(vae, TILE, OVERLAP, TILE_BATCH).encode(img)
        ppx32 = TiledVAE(vae, TILE, OVERLAP, TILE_BATCH).decode(z["fp32"])
        pz16 = TiledVAE(vae, TILE, OVERLAP, TILE_BATCH,
                        torch.bfloat16).encode(img)
        ppx16 = TiledVAE(vae, TILE, OVERLAP, TILE_BATCH,
                         torch.bfloat16).decode(z["fp32"])
    assert z["fp32"].shape == (TILED_H // 8, TILED_W // 8, 16)
    assert px["fp32"].shape == (TILED_H, TILED_W, 3)
    gates = dict(
        latents_mse_fp32=_mse(z["fp32"], pz32),
        pixels_mse_fp32=_mse(px["fp32"], ppx32),
        latents_mse_bf16=_mse(z["bf16"], pz32),
        latents_mse_bf16_plain=_mse(pz16, pz32),
        pixels_mse_bf16=_mse(px["bf16"], ppx32),
        pixels_mse_bf16_plain=_mse(ppx16, ppx32))
    log(f"  tiled gates: fp32 latents MSE {gates['latents_mse_fp32']:.3e}, "
        f"pixels {gates['pixels_mse_fp32']:.3e} (gate 1e-10); bf16 latents "
        f"{gates['latents_mse_bf16']:.3e} vs the plain bf16 path's "
        f"{gates['latents_mse_bf16_plain']:.3e}, pixels "
        f"{gates['pixels_mse_bf16']:.3e} vs "
        f"{gates['pixels_mse_bf16_plain']:.3e} (gate 4x)")
    assert gates["latents_mse_fp32"] < 1e-10, gates
    assert gates["pixels_mse_fp32"] < 1e-10, gates
    assert gates["latents_mse_bf16"] <= 4 * gates["latents_mse_bf16_plain"]
    assert gates["pixels_mse_bf16"] <= 4 * gates["pixels_mse_bf16_plain"]
    del pz32, ppx32, pz16, ppx16

    one = _seeded_png(d / "one.png", RES, RES, SEED + 21)
    zt = TiledVAE(vae, TILE, OVERLAP, TILE_BATCH).encode(one)
    ze = VAEOnlyEngine(vae, FP32, DEVICE).encode(one[None])[0]
    gates["one_tile_vs_engine_mse"] = _mse(zt, ze)
    log(f"  one {RES}^2 tile through TiledVAE vs VAEOnlyEngine.encode: MSE "
        f"{gates['one_tile_vs_engine_mse']:.3e} (gate 1e-10)")
    assert gates["one_tile_vs_engine_mse"] < 1e-10, gates
    del vae
    torch.cuda.empty_cache()

    backend.reset_launch_counts()
    t0 = time.perf_counter()
    got = latents_main([
        "--vae_checkpoint", art["vae"], "--vae_config_path", art["config"],
        "--image_path", str(d / "big.png"), "--output_dir",
        str(d / "latents"), "--tiled", "--tile_size", str(TILE),
        "--tile_overlap", str(OVERLAP), "--output_format", "npz",
        "--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = backend.launch_counts()
    assert counts == _expected(ENCODE_LAUNCHES["fp32"], 1), counts
    flat = got[str(d / "big.png")]
    err = _mse(flat, flatten_latent_torch_order(z["fp32"]))
    log(f"  latents CLI --tiled: {wall:.2f} s (load included), "
        f"{flat.size} floats, MSE {err:.3e} against the tiled encode")
    assert flat.size == z["fp32"].size and err < 1e-10, err
    out["latents_cli"] = dict(wall_s=wall, launches=counts)

    backend.reset_launch_counts()
    t0 = time.perf_counter()
    rec = recon_main([
        "--vae_checkpoint", art["vae"], "--vae_config_path", art["config"],
        "--image_path", str(d / "big.png"), "--output_dir",
        str(d / "recon"), "--tiled", "--tile_size", str(TILE),
        "--tile_overlap", str(OVERLAP), "--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = backend.launch_counts()
    assert counts == _expected(_plus(ENCODE_LAUNCHES["fp32"],
                                     DECODE_LAUNCHES["fp32"]), 1), counts
    assert np.isfinite(rec["psnr"]) and rec["latent_shape"] == (
        1, TILED_H // 8, TILED_W // 8, 16), rec
    log(f"  reconstruct CLI --tiled: {wall:.2f} s (load included), PSNR "
        f"{rec['psnr']:.3f} dB, MSE {rec['mse']:.6f} (random weights), "
        f"compression {rec['compression']:.2f}:1")
    out["reconstruct_cli"] = dict(wall_s=wall, launches=counts, **rec)
    return dict(out, gates=gates)


def phase_train_decoder(art, json_path):
    """``python -m vae_tagger_tpu_torch.train.train_decoder`` on the 8
    images: 2 epochs, batch 4, ``--cache_latents``, warm-started from the
    head checkpoint, in bf16 and in fp32, then once with
    ``--transfer_format yuv420 --cache_latents`` (bf16).  7 training
    images make 2 batches and 1 validation image 1 (filled to 4 rows).
    Checks of each run: the exact launches (one encode per batch of epoch
    1: 3 x (A 2, stats 20, B 20, C 1); epoch 2 and the final phase none;
    no D or E anywhere), finite losses, every head parameter changed,
    every VAE tensor as loaded, the final phase read the cache alone, the
    exports classify through ``TaggerEngine``.  Then the steady step time
    without and with the cache (images/s, peak memory) on one batch."""
    import numpy as np
    import torch
    from vae_tagger_tpu_torch.data.dataset import TaggedImageDataset
    from vae_tagger_tpu_torch.data.loader import DataLoader, train_val_split
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine
    from vae_tagger_tpu_torch.io.checkpoints import load_state_file
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.train import train_decoder
    from vae_tagger_tpu_torch.train.steps import DecoderSteps

    log("train_decoder: python -m vae_tagger_tpu_torch.train.train_decoder, "
        f"frozen full-width VAE, {N_IMAGES} {RES}px images, 2 epochs, batch "
        f"{BATCH}, --cache_latents, bf16 and fp32, then yuv420 in bf16")
    n_train, n_val = (len(ix) for ix in train_val_split(N_IMAGES, 0.1,
                                                        seed=SEED or 42))
    val_batches = -(-n_val // BATCH)
    batches = -(-n_train // BATCH) + val_batches
    vae_before = load_state_file(art["vae"])
    head_before = torch.load(art["decoder"], weights_only=True)
    seen = {}
    real_init = DecoderSteps.__init__
    real_cache = train_decoder.LatentCache

    class Cache(real_cache):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["cache"] = self

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        seen["steps"] = self

    report = {}
    DecoderSteps.__init__ = init
    train_decoder.LatentCache = Cache
    try:
        for key, precision, flags in (
                ("bf16", "bf16", ()), ("fp32", "no", ()),
                ("yuv420_bf16", "bf16", ("--transfer_format", "yuv420"))):
            out = WORK / f"train_decoder_{key}"
            argv = ["--json_path", json_path, "--tags_csv_path",
                    art["tags"], "--vae_checkpoint", art["vae"],
                    "--vae_config_path", art["config"], "--decoder_checkpoint",
                    art["decoder"], "--output_dir", str(out),
                    "--resolution", str(RES), "--train_batch_size",
                    str(BATCH), "--num_epochs", "2", "--mixed_precision",
                    precision, "--lr_warmup_steps", "0", "--save_steps", "1",
                    "--logging_steps", "1", "--num_workers", "4", "--seed",
                    str(SEED), "--cache_latents", "--device", DEVICE, *flags]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            backend.reset_launch_counts()
            t0 = time.perf_counter()
            state = train_decoder.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = backend.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            enc = ENCODE_LAUNCHES["bf16" if precision == "bf16" else "fp32"]
            expect = _expected(enc, batches)
            log(f"  train_decoder {key}: {wall:.2f} s (load, 2 epochs, "
                f"exports and the final phase), peak device memory "
                f"{peak / 2**30:.2f} GiB; launches "
                f"{({k: c for k, c in counts.items() if c})}")
            assert counts == expect, (key, counts, expect)
            cache = seen["cache"]
            assert (cache.hits, cache.misses) == (val_batches, 0), (
                cache.hits, cache.misses)
            assert len(cache.latents) == N_IMAGES, len(cache.latents)
            history = json.loads((out / "training_history.json").read_text())
            values = history["train_loss"] + history["val_loss"]
            assert len(history["train_loss"]) == 2 and np.isfinite(
                values).all(), history
            after = torch.load(out / "pytorch_model.bin", weights_only=True)
            names = [n for n, _ in state.decoder.named_parameters()]
            same = [n for n in names if torch.equal(after[n],
                                                    head_before[n])]
            assert not same, same[:5]
            vae_now = {k: v.cpu() for k, v in
                       seen["steps"].vae.state_dict().items()}
            moved = [k for k, v in vae_now.items()
                     if not torch.equal(v, vae_before[k])]
            assert not moved and set(state.optimizer.params) == set(
                state.decoder.parameters()), moved[:5]
            for f in ("best_pytorch_model.bin", "optimal_thresholds.json",
                      "evaluation_results.csv",
                      "evaluation_results_overall.json"):
                assert (out / f).exists(), f
            log(f"  train_decoder {key}: losses train "
                f"{history['train_loss']}, val {history['val_loss']}; "
                f"head {len(names)}/{len(names)} parameters changed, VAE "
                f"{len(vae_now)} tensors as loaded; the final phase read "
                f"{cache.hits} cached batch(es), encoded {cache.misses}")
            report[key] = dict(wall_s=wall, launches=counts,
                               expected_launches=expect,
                               peak_mem_bytes=peak, history=history,
                               cached_samples=len(cache.latents),
                               cache_bytes=cache.bytes)
            del state
            seen.clear()
            torch.cuda.empty_cache()
    finally:
        DecoderSteps.__init__ = real_init
        train_decoder.LatentCache = real_cache

    out16 = WORK / "train_decoder_bf16"
    eng = TaggerEngine.load(
        vae_checkpoint=art["vae"], vae_config_path=art["config"],
        decoder_checkpoint=str(out16 / "best_pytorch_model.bin"),
        tags_csv_path=art["tags"], mixed_precision="bf16", device=DEVICE)
    dataset = TaggedImageDataset(json_path, art["tags"], RES, seed=SEED,
                                 return_triplets=False)
    batch = next(iter(DataLoader(dataset, BATCH, shuffle=False,
                                 num_workers=4)))
    probs = eng.classify(batch["pixel_values"])
    assert probs.shape == (BATCH, NUM_TAGS) and np.isfinite(probs).all()
    log(f"  the bf16 export classifies through TaggerEngine: max "
        f"probability {probs.max():.4f}")
    del eng

    # steady steps: the encode + head step, and the head step on cached
    # latents
    from vae_tagger_tpu_torch.infer.engine import build_decoder
    from vae_tagger_tpu_torch.io.checkpoints import load_decoder, load_vae
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.train.schedule import build_lr_schedule
    from vae_tagger_tpu_torch.train.state import TrainState, build_optimizer

    vae = load_vae(art["vae"], art["config"]).to(DEVICE).eval()
    vae.requires_grad_(False)
    for key, dt, iters in (("bf16", torch.bfloat16, 10),
                           ("fp32", torch.float32, 4)):
        head = load_decoder(build_decoder(NUM_TAGS, True, None, 16, SEED),
                            art["decoder"]).to(DEVICE)
        opt = build_optimizer(head.parameters(),
                              build_lr_schedule("constant", 1e-4, 0, 100))
        state = TrainState(vae=None, decoder=head, optimizer=opt)
        steps = DecoderSteps(vae, LossConfig(), compute_dtype=dt, seed=SEED)
        times = {}
        dev = steps.to_device(batch)
        latents = steps.encode_batch(dev)
        for name, fn in (
                ("encode", lambda i: steps.train_step(state, batch, i)),
                ("cached", lambda i: steps.train_step_from_latents(
                    state, latents, dev["labels"], i))):
            fn(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for i in range(iters):
                fn(1 + i)
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / iters
            times[name] = dict(step_s=step_s,
                               images_per_s=BATCH / step_s,
                               peak_mem_bytes=torch.cuda
                               .max_memory_allocated())
        log(f"  steady train_decoder step, {key}, batch {BATCH}: encode + "
            f"head {times['encode']['step_s'] * 1e3:.2f} ms "
            f"({times['encode']['images_per_s']:.2f} images/s, peak "
            f"{times['encode']['peak_mem_bytes'] / 2**30:.2f} GiB); from "
            f"cached latents {times['cached']['step_s'] * 1e3:.2f} ms "
            f"({times['cached']['images_per_s']:.2f} images/s, peak "
            f"{times['cached']['peak_mem_bytes'] / 2**30:.2f} GiB); host "
            f"clock, {iters} steps")
        report[key]["steady"] = times
        del head, opt, state, steps, latents, dev
        torch.cuda.empty_cache()
    del vae
    torch.cuda.empty_cache()
    return report


def phase_buckets(art):
    """Aspect-ratio buckets and the YUV 4:2:0 wire format:

    - seeded PNGs at 1408x1152, 1024x768 and 1024x1024 go to the buckets
      (704, 576), (768, 576) and (512, 512);
    - ``train_full --use_bucketing`` and ``train_vae --use_bucketing`` for
      one epoch at batch 1, bf16 and fp32 (``_train_cli``: the exact
      launches of every step as at 1024px, one bucket a batch);
    - the fp32 gradient gate of train_full on the 704x576 triplet;
    - the infer CLI on the 8 images at 1024px with ``--transfer_format
      yuv420``, bf16 and fp32, against its RGB run: every probability
      within YUV_PROB_BOUND, the exact launches;
    - ``yuv420_to_rgb_uint8`` on the card against the same function on
      the CPU: at most 1 apart, equal on >= 99.9% of values."""
    import numpy as np
    import torch
    from vae_tagger_tpu_torch.data.bucketing import load_and_transform_image_yuv
    from vae_tagger_tpu_torch.data.dataset import TaggedImageDataset
    from vae_tagger_tpu_torch.data.loader import DataLoader
    from vae_tagger_tpu_torch.data.paths import get_image_paths
    from vae_tagger_tpu_torch.infer.__main__ import main as infer_main
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.image import yuv420_to_rgb_uint8

    log("buckets: three seeded images at 1408x1152, 1024x768, 1024x1024; "
        "train_full and train_vae --use_bucketing, bf16 and fp32; the "
        "bucketed fp32 gradient gate; the infer CLI with --transfer_format "
        "yuv420")
    d = WORK / "buckets"
    (d / "images").mkdir(parents=True, exist_ok=True)
    data = {}
    for i, (w, h) in enumerate(BUCKET_IMAGES):
        p = d / "images" / f"b{i}_{w}x{h}.png"
        _seeded_png(p, w, h, SEED + 30 + i)
        data[str(p)] = ", ".join(f"tag_{t}:0.9" for t in (i, i + 1, 7))
    json_path = d / "data.json"
    json_path.write_text(json.dumps(data, indent=1))
    ds = TaggedImageDataset(str(json_path), art["tags"], RES, seed=SEED,
                            use_bucketing=True)
    got = {_image_size(p): ds.bucket_of(i)
           for i, p in enumerate(ds.image_paths)}
    log(f"  bucket assignment: {got}")
    assert got == BUCKET_IMAGES, got
    report = {"buckets": {f"{w}x{h}": list(b) for (w, h), b in got.items()}}
    # the 704x576 triplet, its members in the anchor's bucket
    idx = next(i for i, p in enumerate(ds.image_paths)
               if ds.bucket_of(i) == BUCKET)
    batch = next(iter(DataLoader(ds, 1, shuffle=False, num_workers=3,
                                 indices=[idx])))
    shape = (1, BUCKET[1], BUCKET[0], 3)
    assert all(batch[k].shape == shape
               for k in ("anchor", "positive", "negative")), shape
    for trainer in ("train_full", "train_vae"):
        for precision, dt, iters in (("bf16", torch.bfloat16, 10),
                                     ("no", torch.float32, 4)):
            key = "bf16" if precision == "bf16" else "fp32"
            state, _, rep = _train_cli(art, str(json_path), precision,
                                       trainer, ("--use_bucketing",),
                                       n_images=len(BUCKET_IMAGES))
            if trainer == "train_full":  # its steady step at 704x576
                step_s, peak, _ = _steady_step(state, batch, dt, iters, 1000)
                log(f"  steady train_full step at {BUCKET[0]}x{BUCKET[1]}, "
                    f"{key}: {step_s * 1e3:.1f} ms, "
                    f"{TRAIN_ROWS / step_s:.3f} images/s (host clock, "
                    f"{iters} steps), peak device memory "
                    f"{peak / 2**30:.2f} GiB")
                rep.update(step_s=step_s, images_per_s=TRAIN_ROWS / step_s,
                           step_peak_mem_bytes=peak)
            report[f"{trainer}_{key}"] = rep
            del state
            torch.cuda.empty_cache()
    report["gradient_gate"] = _gradient_gate(art, batch)

    # the infer CLI, RGB against YUV 4:2:0, bf16 and fp32, on photo-like
    # images: the JAX package's bound holds for band-limited chroma (its
    # test images, smooth content with noise of sigma 3); 4:2:0 drops by
    # design the chroma of the training images' per-pixel noise of sigma 20
    photos = d / "photos"
    photos.mkdir(exist_ok=True)
    for i in range(N_IMAGES):
        _photo_png(photos / f"photo_{i:02d}.png", RES, RES, SEED + 40 + i)
    paths = [str(p) for p in get_image_paths(str(photos))]
    n_batches = -(-N_IMAGES // BATCH)
    probs = {}
    for key, precision in (("bf16", "bf16"), ("fp32", "no")):
        for fmt in ("rgb", "yuv420"):
            backend.reset_launch_counts()
            t0 = time.perf_counter()
            res = infer_main([
                "--vae_checkpoint", art["vae"], "--vae_config_path",
                art["config"], "--decoder_checkpoint", art["decoder"],
                "--image_path", str(photos), "--tags_csv_path",
                art["tags"], "--output_dir", str(d / f"infer_{key}_{fmt}"),
                "--resolution", str(RES), "--batch_size", str(BATCH),
                "--num_workers", "4", "--mixed_precision", precision,
                "--confidence_threshold", "0", "--transfer_format", fmt,
                "--device", DEVICE])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = backend.launch_counts()
            assert counts == _expected(ENCODE_LAUNCHES[key], n_batches), \
                (key, fmt, counts)
            probs[key, fmt] = {p: {t["tag"]: t["confidence"]
                                   for t in r["predicted_tags"]}
                               for p, r in res.items()}
            report[f"infer_{fmt}_{key}"] = dict(wall_s=wall,
                                                launches=counts)
            log(f"  infer CLI {fmt} {key}: {len(res)} images in "
                f"{wall:.2f} s; launches "
                f"{({k: c for k, c in counts.items() if c})}")
        a, b = probs[key, "rgb"], probs[key, "yuv420"]
        assert sorted(a) == sorted(b) == sorted(paths)
        worst = max(abs(a[p][t] - b[p][t]) for p in a for t in a[p])
        log(f"  {key}: largest |p_yuv420 - p_rgb| over {N_IMAGES} images x "
            f"{NUM_TAGS} tags: {worst:.4f} (bound {YUV_PROB_BOUND}, the JAX "
            f"package's chroma bound of tests/test_yuv.py)")
        assert worst < YUV_PROB_BOUND, worst
        report[f"yuv_prob_diff_{key}"] = worst
    planes = [load_and_transform_image_yuv(p, RES) for p in paths]
    y = torch.from_numpy(np.stack([p[0] for p in planes]))
    c = torch.from_numpy(np.stack([p[1] for p in planes]))
    on_card = yuv420_to_rgb_uint8(y.to(DEVICE), c.to(DEVICE)).cpu()
    on_cpu = yuv420_to_rgb_uint8(y, c)
    diff = (on_card.int() - on_cpu.int()).abs()
    equal = (diff == 0).float().mean().item()
    log(f"  yuv420_to_rgb_uint8 on the card vs the CPU over {N_IMAGES} "
        f"{RES}px images: largest difference {diff.max().item()}, equal on "
        f"{equal:.6%} (gate <= 1, >= 99.9%)")
    assert diff.max().item() <= 1 and equal >= 0.999
    report["yuv_device_vs_cpu"] = dict(max_diff=diff.max().item(),
                                       equal_share=equal)
    return report


# --------------------------------------------------------------------------
# slice 10: the HTTP server, attention maps, the epoch loop's drills
# --------------------------------------------------------------------------

SERVE_IMAGES = 96
SERVE_CLIENTS = 16
SERVE_MAX_BATCH = 8
SERVE_SOURCE = (2048, 1536)
# a served response against engine.classify of the same decoded pixels in
# a batch of 4: fp32 as the 1e-5 the HTTP tests hold on the CPU; bf16 2x
# the 5.1e-3 measured on an H100 80GB HBM3 at 700 W (PERF.md §6), cuDNN's
# other algorithms for another batch size moving bf16 roundings
SERVE_TOL = {"fp32": 1e-5, "bf16": 1e-2}
# kernel names (csrc/) of A, B', C', D', E' and F in a chrome trace
PROFILE_KERNELS = {"A": ("gn_stats_vec_kernel", "gn_apply_vec_kernel"),
                   "F": ("gn_bwd_reduce_kernel", "gn_bwd_apply_kernel"),
                   "B'": ("conv3x3_tc_kernel",),
                   "C'": ("flash_fwd_tc_kernel",),
                   "D'": ("flash_bwd_dq_tc_kernel",),
                   "E'": ("flash_bwd_dk_tc_kernel", "flash_bwd_dv_tc_kernel")}


def _serve_images(n=SERVE_IMAGES, seed=SEED + 10):
    """n seeded 2048x1536 photo-like images, alternately JPEG (q90) and
    PNG bytes, made on a thread pool (PIL encodes without the GIL)."""
    import concurrent.futures
    import io

    import numpy as np
    from PIL import Image

    w, h = SERVE_SOURCE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bank = np.random.default_rng(seed).normal(0, 6, size=(4, h, w)).astype(
        np.float32)

    def make(i):
        rng = np.random.default_rng(seed + 1 + i)
        ph = rng.uniform(0, 2 * np.pi, size=3)
        fr = rng.uniform(20, 90, size=3)
        img = np.stack([128 + 100 * np.sin(xx / fr[c] + ph[c])
                        * np.cos(yy / fr[(c + 1) % 3]) + bank[(i + c) % 4]
                        for c in range(3)], -1)
        buf = io.BytesIO()
        im = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
        if i % 2:
            im.save(buf, "PNG", compress_level=1)
        else:
            im.save(buf, "JPEG", quality=90)
        return buf.getvalue()

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        return list(ex.map(make, range(n)))


def _post(base, data, query="", timeout=600):
    """(status, headers, body JSON) of one POST /classify."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"{base}/classify{query}", data=data,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.load(e)


def _traffic(server, blobs, clients=SERVE_CLIENTS):
    """POST every blob from ``clients`` concurrent clients; (responses in
    blob order, per-request seconds, wall seconds)."""
    import concurrent.futures

    base = f"http://127.0.0.1:{server.port}"

    def one(data):
        t0 = time.perf_counter()
        out = _post(base, data)
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(clients) as ex:
        res = list(ex.map(one, blobs))
    wall = time.perf_counter() - t0
    return [r for r, _ in res], [s for _, s in res], wall


def phase_serve(art):
    """``TaggerServer`` (the port's HTTP server) on 127.0.0.1 on an
    ephemeral port at 1024px, max_batch 8, fp32 (the default) then bf16:
    16 concurrent clients post 96 seeded 2048x1536 images (JPEG q90 and
    PNG, alternately).  Gates: every response 200 with the entry schema
    and every tag's confidence (threshold 0: all 2,000) the 4-decimal
    rounding of the engine's probability of the same bytes; every served
    probability vector (recorded at the worker's fetch) within SERVE_TOL
    of ``engine.classify`` of the same decoded pixels in batches of 4 (so
    a response does not depend on the batch it rode in); the exact
    launches per dispatched batch (A 2, stats 20, B 20, C 1).  Reported:
    images/s, p50/p99 latency, the batch-size histogram, the rate with
    max_batch 1, ``os.cpu_count()`` and the native decode formats.  Then
    a yuv420 server (bf16) within YUV_PROB_BOUND of the RGB server on the
    same 16 images, and 413, 400 and 503 provoked once each."""
    import concurrent.futures
    import os

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from vae_tagger_tpu_torch import native
    from vae_tagger_tpu_torch.data.bucketing import decode_bytes_square
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.serve import TaggerServer

    formats = sorted(native.decode_formats())
    log(f"serve: TaggerServer at {RES}px, max_batch {SERVE_MAX_BATCH}, "
        f"{SERVE_CLIENTS} concurrent clients, {SERVE_IMAGES} seeded "
        f"{SERVE_SOURCE[0]}x{SERVE_SOURCE[1]} images (JPEG q90 and PNG); "
        f"os.cpu_count() {os.cpu_count()}, native decode {formats}")
    if not native.available():
        raise AssertionError("the native resize library did not build")
    t0 = time.perf_counter()
    blobs = _serve_images()
    log(f"  {len(blobs)} images encoded in {time.perf_counter() - t0:.1f} s "
        f"({sum(map(len, blobs)) / 2**20:.0f} MiB)")
    kw = dict(vae_checkpoint=art["vae"], decoder_checkpoint=art["decoder"],
              tags_csv_path=art["tags"], vae_config_path=art["config"])
    t0 = time.perf_counter()
    pixels = [decode_bytes_square(b, RES) for b in blobs]
    one_thread = (time.perf_counter() - t0) / len(blobs)
    # what the host can decode with as many threads as clients: the
    # served rate's ceiling from the decode alone
    with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as ex:
        t0 = time.perf_counter()
        list(ex.map(lambda b: decode_bytes_square(b, RES), blobs))
        decode_rate = len(blobs) / (time.perf_counter() - t0)
    log(f"  decode to {RES}px: {one_thread * 1e3:.1f} ms an image on one "
        f"thread; {decode_rate:.1f} images/s on {SERVE_CLIENTS} threads")
    report = dict(cpu_count=os.cpu_count(), native_formats=formats,
                  decode_ms_one_thread=one_thread * 1e3,
                  decode_images_per_s_threads=decode_rate)
    rgb_full = {}
    for key, precision in (("fp32", None), ("bf16", "bf16")):
        engine = TaggerEngine.load(mixed_precision=precision, **kw)
        t0 = time.perf_counter()
        server = TaggerServer(engine, resolution=RES, threshold=0.0, port=0,
                              max_batch=SERVE_MAX_BATCH)
        warm = time.perf_counter() - t0
        served = []
        resolve = server.worker._resolve

        def recording(items, device_probs, n, resolve=resolve,
                      served=served):
            resolve(items, device_probs, n)
            served.extend((it.pixels, it.probs) for it in items)

        server.worker._resolve = recording
        with server:
            torch.cuda.synchronize()
            backend.reset_launch_counts()
            # device time only (CUPTI): the busy share of the served window
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                responses, lat, wall = _traffic(server, blobs)
                torch.cuda.synchronize()
            counts = backend.launch_counts()
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not _annotation(e)) / 1e3
        hist = dict(sorted(server.worker.batch_sizes.items()))
        n_batches = sum(hist.values())
        expect = _expected(ENCODE_LAUNCHES[key], n_batches)
        log(f"  {key}: warm-up of batches 1..{SERVE_MAX_BATCH} "
            f"{warm:.1f} s; {len(blobs)} requests in {wall:.2f} s: "
            f"{len(blobs) / wall:.3f} images/s, latency p50 "
            f"{np.percentile(lat, 50) * 1e3:.0f} ms p99 "
            f"{np.percentile(lat, 99) * 1e3:.0f} ms; {n_batches} batches, "
            f"sizes {hist}; device busy {busy_ms:.0f} ms of the "
            f"{wall * 1e3:.0f} ms window (idle "
            f"{1 - busy_ms / 1e3 / wall:.1%})")
        log(f"  launches, serve {key}: {counts}")
        for k, want in expect.items():
            assert counts[k] == want, (key, k, counts[k], want)
        assert sum(k * n for k, n in hist.items()) == len(blobs) \
            == len(served)
        # every served vector against classify of its pixels, batches of 4
        worst = 0.0
        for i in range(0, len(served), BATCH):
            chunk = served[i:i + BATCH]
            ref = engine.classify(np.stack([p for p, _ in chunk]))
            got = np.stack([q for _, q in chunk])
            assert np.isfinite(got).all()
            worst = max(worst, float(np.abs(got - ref).max()))
        log(f"  {key}: served probabilities vs engine.classify of the same "
            f"pixels in batches of {BATCH}: max |diff| {worst:.3e} (gate "
            f"{SERVE_TOL[key]:.0e})")
        assert worst <= SERVE_TOL[key], (key, worst)
        # every HTTP response: the schema, and its confidences
        ref = np.concatenate([engine.classify(np.stack(pixels[i:i + BATCH]))
                              for i in range(0, len(pixels), BATCH)])
        names = engine.tag_names
        http_worst = 0.0
        for i, (status, _, body) in enumerate(responses):
            assert status == 200, (i, status, body)
            assert set(body) == {"predicted_tags",
                                 "total_tags_above_threshold",
                                 "max_confidence", "avg_confidence_top5"}
            assert body["total_tags_above_threshold"] == len(names)
            conf = {t["tag"]: t["confidence"] for t in body["predicted_tags"]}
            got = np.array([conf[n] for n in names])
            http_worst = max(http_worst, float(np.abs(got - ref[i]).max()))
            rgb_full.setdefault(key, []).append(got)
        log(f"  {key}: HTTP confidences vs engine.classify of the bytes: "
            f"max |diff| {http_worst:.3e} (4-decimal rounding, gate "
            f"{5e-5 + SERVE_TOL[key]:.1e})")
        assert http_worst <= 5e-5 + SERVE_TOL[key], (key, http_worst)
        # the same traffic at max_batch 1, for contrast
        with TaggerServer(engine, resolution=RES, threshold=0.0, port=0,
                          max_batch=1, warmup=False) as one:
            _, lat1, wall1 = _traffic(one, blobs)
        log(f"  {key}: the same traffic at max_batch 1: "
            f"{len(blobs) / wall1:.3f} images/s, latency p50 "
            f"{np.percentile(lat1, 50) * 1e3:.0f} ms p99 "
            f"{np.percentile(lat1, 99) * 1e3:.0f} ms")
        report[key] = dict(
            warmup_s=warm, wall_s=wall, images_per_s=len(blobs) / wall,
            device_busy_ms=busy_ms, idle_share=1 - busy_ms / 1e3 / wall,
            latency_p50_ms=float(np.percentile(lat, 50) * 1e3),
            latency_p99_ms=float(np.percentile(lat, 99) * 1e3),
            batch_sizes=hist, batches=n_batches, launches=counts,
            expected_launches=expect, max_abs_diff_vs_classify=worst,
            http_max_abs_diff=http_worst,
            max_batch_1=dict(images_per_s=len(blobs) / wall1,
                             latency_p50_ms=float(
                                 np.percentile(lat1, 50) * 1e3),
                             latency_p99_ms=float(
                                 np.percentile(lat1, 99) * 1e3)))
        if key == "bf16":
            report["yuv420"], report["rejections"] = _serve_yuv_and_rejects(
                engine, blobs, rgb_full["bf16"])
        del engine, server
        torch.cuda.empty_cache()
    return report


def _serve_yuv_and_rejects(engine, blobs, rgb_confidences):
    """A yuv420 server on the first 16 images against the RGB server's
    confidences; then 413, 400 and 503, each provoked once."""
    import numpy as np
    from vae_tagger_tpu_torch.serve import TaggerServer

    n = 16
    with TaggerServer(engine, resolution=RES, threshold=0.0, port=0,
                      max_batch=SERVE_MAX_BATCH,
                      transfer_format="yuv420") as server:
        responses, _, wall = _traffic(server, blobs[:n])
    names = engine.tag_names
    worst = 0.0
    for i, (status, _, body) in enumerate(responses):
        assert status == 200, (status, body)
        conf = {t["tag"]: t["confidence"] for t in body["predicted_tags"]}
        got = np.array([conf[t] for t in names])
        worst = max(worst, float(np.abs(got - rgb_confidences[i]).max()))
    log(f"  bf16 yuv420 server: {n} requests in {wall:.2f} s; largest "
        f"|p_yuv420 - p_rgb| {worst:.4f} (bound {YUV_PROB_BOUND})")
    assert worst < YUV_PROB_BOUND, worst

    class Held:
        """The engine, its first dispatch held until released: the queue
        of one then fills, and every later request is turned away."""

        def __init__(self):
            self.entered, self.release = (threading.Event(),
                                          threading.Event())

        def classify_async(self, px):
            self.entered.set()
            self.release.wait(timeout=120)
            return engine.classify_async(px)

    import concurrent.futures
    import threading

    codes = {}
    with TaggerServer(engine, resolution=RES, port=0, warmup=False,
                      max_batch=1, max_queue=1) as server:
        base = f"http://127.0.0.1:{server.port}"
        codes["413"] = _post(base, b"\0" * (33 << 20))[0]
        codes["400"] = _post(base, b"not an image")[0]
        held = server.worker.engine = Held()
        with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as ex:
            first = ex.submit(_post, base, blobs[0])
            assert held.entered.wait(timeout=120)
            rest = [ex.submit(_post, base, b)
                    for b in blobs[1:SERVE_CLIENTS]]
            # all but the one queued request come back while the first
            # is held
            deadline = time.monotonic() + 120
            while (sum(f.done() for f in rest) < len(rest) - 1
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            held.release.set()
            responses = [f.result(timeout=600) for f in [first, *rest]]
    statuses = [s for s, _, _ in responses]
    busy = [h for s, h, _ in responses if s == 503]
    codes["503"] = len(busy)
    log(f"  rejections: 413 -> {codes['413']}, undecodable -> "
        f"{codes['400']}, {SERVE_CLIENTS} concurrent at max_queue 1 with "
        f"the first dispatch held -> {statuses.count(200)} x 200 and "
        f"{len(busy)} x 503")
    assert codes["413"] == 413 and codes["400"] == 400
    assert statuses.count(200) == 2 and len(busy) == SERVE_CLIENTS - 2
    assert all(h.get("Retry-After") == "1" for h in busy)
    return dict(max_abs_diff_vs_rgb=worst, wall_s=wall), codes


def phase_attention_maps(art):
    """``TaggerEngine.get_attention_maps`` on a batch of 4 seeded images at
    1024px, bf16 and fp32: every map finite, the gates in [0, 1], every
    softmax row summing to 1 (1e-5 fp32, 1e-2 bf16, the weights being
    rounded to bf16); the kernel path against the plain path
    (``VAE_TAGGER_TORCH_BACKEND=torch``'s switch, on the card): fp32
    within 1e-4 absolute, bf16 within 4x the plain bf16 path's own
    distance from the plain fp32 path (floor 1e-3); exact launches of the
    kernel path (one encode); then ``python -m
    vae_tagger_tpu_torch.infer.attention_viz`` writes its npz, png and
    index files."""
    import numpy as np
    import torch
    from vae_tagger_tpu_torch.data.bucketing import load_and_transform_image
    from vae_tagger_tpu_torch.data.paths import get_image_paths
    from vae_tagger_tpu_torch.infer.attention_viz import main as viz_main
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine
    from vae_tagger_tpu_torch.ops import backend

    paths = [str(p) for p in get_image_paths(art["images"])][:BATCH]
    px = np.stack([load_and_transform_image(p, resolution=RES)
                   for p in paths])
    kw = dict(vae_checkpoint=art["vae"], decoder_checkpoint=art["decoder"],
              tags_csv_path=art["tags"], vae_config_path=art["config"])
    log(f"attention maps: a batch of {BATCH} at {RES}px through "
        f"TaggerEngine.get_attention_maps, fp32 and bf16, kernel and plain "
        f"paths")
    maps, report = {}, {}
    for key, precision in (("fp32", "no"), ("bf16", "bf16")):
        engine = TaggerEngine.load(mixed_precision=precision, **kw)
        engine.get_attention_maps(px)  # warm
        torch.cuda.synchronize()
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        maps[key, "kernel"] = engine.get_attention_maps(px)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = backend.launch_counts()
        expect = _expected(ENCODE_LAUNCHES[key], 1)
        for k, want in expect.items():
            assert counts[k] == want, (key, k, counts[k], want)
        with backend.backend("torch"):
            maps[key, "plain"] = engine.get_attention_maps(px)
        m = maps[key, "kernel"]
        assert set(m) == {"channel_attention", "spatial_attention",
                          "self_attention"}, set(m)
        assert m["channel_attention"].shape == (BATCH, 1, 1, 16)
        assert m["spatial_attention"].shape == (BATCH, RES // 8, RES // 8, 1)
        assert m["self_attention"].shape == (BATCH, 8, 64, 64)
        assert all(np.isfinite(v).all() for v in m.values())
        for gate in ("channel_attention", "spatial_attention"):
            assert m[gate].min() >= 0 and m[gate].max() <= 1
        rows = float(np.abs(m["self_attention"].sum(-1) - 1).max())
        assert rows <= (1e-5 if key == "fp32" else 1e-2), (key, rows)
        report[key] = dict(ms=ms, launches=counts, expected_launches=expect,
                           softmax_row_err=rows)
        used = {k: c for k, c in counts.items() if c}
        log(f"  {key}: {ms:.1f} ms host clock; softmax rows within "
            f"{rows:.2e} of 1; launches {used}")
        del engine
    for key in ("fp32", "bf16"):
        diff = max(float(np.abs(maps[key, "kernel"][k]
                                - maps[key, "plain"][k]).max())
                   for k in maps[key, "kernel"])
        if key == "fp32":
            tol = 1e-4
        else:
            own = max(float(np.abs(maps["bf16", "plain"][k]
                                   - maps["fp32", "plain"][k]).max())
                      for k in maps["fp32", "plain"])
            diff = max(float(np.abs(maps["bf16", "kernel"][k]
                                    - maps["fp32", "plain"][k]).max())
                       for k in maps["fp32", "plain"])
            tol = max(4 * own, 1e-3)
        log(f"  {key}: kernel path vs plain {'fp32 ' if key == 'bf16' else ''}"
            f"path, max |diff| over the maps {diff:.3e} (gate {tol:.3e})")
        assert diff <= tol, (key, diff, tol)
        report[key].update(max_abs_diff_vs_plain=diff, tol=tol)
    out = WORK / "attention_out"
    index = viz_main(["--vae_checkpoint", art["vae"], "--vae_config_path",
                      art["config"], "--decoder_checkpoint", art["decoder"],
                      "--tags_csv_path", art["tags"], "--image_path",
                      art["images"], "--output_dir", str(out),
                      "--resolution", str(RES), "--batch_size", str(BATCH),
                      "--max_images", str(BATCH), "--mixed_precision",
                      "bf16", "--device", DEVICE])
    files = sorted(p.name for p in out.iterdir())
    assert len(index["images"]) == BATCH
    assert "attention_maps_index.json" in files
    assert sum(f.endswith("_attention.npz") for f in files) == BATCH
    assert sum(f.endswith("_spatial.png") for f in files) == BATCH
    assert sum(f.endswith("_mhsa.png") for f in files) == BATCH
    log(f"  attention_viz CLI: {len(files)} files ({BATCH} npz, "
        f"{2 * BATCH} png, the index)")
    report["cli_files"] = len(files)
    return report


def _drill_argv(art, json_path, out, *flags):
    return ["--json_path", json_path, "--tags_csv_path", art["tags"],
            "--vae_checkpoint", art["vae"], "--vae_config_path",
            art["config"], "--decoder_checkpoint", art["decoder"],
            "--output_dir", str(out), "--resolution", str(RES),
            "--train_batch_size", "1", "--mixed_precision", "bf16",
            "--lr_warmup_steps", "0", "--save_steps", "1",
            "--logging_steps", "1", "--num_workers", "4", "--seed",
            str(SEED), "--device", DEVICE, *flags]


def _flat_tensors(tree, prefix=""):
    import torch

    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    for k, v in items:
        out.update(_flat_tensors(v, f"{prefix}/{k}"))
    return out


def phase_drills(art, json_path):
    """The epoch loop's preemption, profiling and background checkpoints
    on ``train_full`` in bf16 at 1024px, batch 1, the simplified loss, the
    8 images (7 train steps an epoch, 1 validation batch):

    - ``VAE_TAGGER_PREEMPT_AFTER_STEPS=2`` writes ``interrupt_checkpoint``
      after 2 steps (exact launches: 2 steps) and skips the final phase;
    - ``--resume_from`` it for 2 epochs with ``--profile_steps 2``: the
      resume skips the 2 trained batches, trains 5 + 7 steps, validates
      twice and runs the final phase (exact launches); the chrome trace
      names A, B', C', D' and E'; each epoch's checkpoint from the
      background writer equals, bit for bit, a synchronous host snapshot
      taken at the same call of the same run (the second epoch trains
      while the first epoch's write runs);
    - a real SIGTERM sent to ``python -m
      vae_tagger_tpu_torch.train.train_full``'s process after its first
      step: exit 0, ``interrupt_checkpoint`` at a step short of the
      epoch, no final phase."""
    import os
    import signal as _signal

    import torch
    from vae_tagger_tpu_torch.data.loader import train_val_split
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.train import train_full
    from vae_tagger_tpu_torch.train.loop import EpochLoop, HostSnapshot

    n_train, n_val = (len(ix) for ix in train_val_split(N_IMAGES, 0.1,
                                                        seed=SEED or 42))
    step = TRAIN_STEP_LAUNCHES["bf16"]
    val = ENCODE_LAUNCHES["bf16"]
    log(f"training drills: train_full bf16 at {RES}px, batch 1, "
        f"{n_train} steps an epoch")
    report = {}

    out = WORK / "drill"
    os.environ["VAE_TAGGER_PREEMPT_AFTER_STEPS"] = "2"
    try:
        torch.cuda.synchronize()
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_full.main(_drill_argv(art, json_path, out,
                                            "--num_epochs", "3"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = backend.launch_counts()
    finally:
        del os.environ["VAE_TAGGER_PREEMPT_AFTER_STEPS"]
    ckpt = out / "interrupt_checkpoint"
    assert state.step == 2 and (ckpt / "train_state.pt").exists()
    assert not (out / "optimal_thresholds.json").exists()
    expect = _expected(step, 2)
    for k, want in expect.items():
        assert counts[k] == want, ("drill", k, counts[k], want)
    log(f"  drill (VAE_TAGGER_PREEMPT_AFTER_STEPS=2): interrupt checkpoint "
        f"at step {state.step} in {wall:.1f} s, no final phase; launches "
        f"{({k: c for k, c in counts.items() if c})}")
    report["drill"] = dict(step=state.step, wall_s=wall, launches=counts,
                           expected_launches=expect)
    del state

    snapshots = {}
    orig = EpochLoop._checkpoint

    def timed(callback, epoch):
        """The callback, its seconds on the writer thread recorded."""
        def run(snapshot, e):
            t0 = time.perf_counter()
            callback(snapshot, e)
            snapshots[epoch, "write_s"] = (snapshots.get((epoch, "write_s"),
                                                         0.0)
                                           + time.perf_counter() - t0)
        return run

    def checkpoint_beside_a_sync_snapshot(self, callbacks, state, epoch):
        snapshots[epoch] = _flat_tensors(HostSnapshot(state).state_dict())
        t0 = time.perf_counter()
        orig(self, [timed(c, epoch) for c in callbacks], state, epoch)
        snapshots[epoch, "submit_s"] = time.perf_counter() - t0

    out2 = WORK / "drill_resume"
    EpochLoop._checkpoint = checkpoint_beside_a_sync_snapshot
    try:
        torch.cuda.synchronize()
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_full.main(_drill_argv(
            art, json_path, out2, "--num_epochs", "2", "--resume_from",
            str(ckpt), "--profile_steps", "2"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = backend.launch_counts()
    finally:
        EpochLoop._checkpoint = orig
    steps = (n_train - 2) + n_train
    assert state.step == 2 + steps, state.step
    expect = {k: steps * step.get(k, 0) + 2 * n_val * val.get(k, 0)
              + n_val * val.get(k, 0) for k in counts}
    for k, want in expect.items():
        assert counts[k] == want, ("resume", k, counts[k], want)
    assert (out2 / "optimal_thresholds.json").exists()
    log(f"  resume from step 2 for 2 epochs: {steps} steps, 2 validations "
        f"and the final phase in {wall:.1f} s; launches "
        f"{({k: c for k, c in counts.items() if c})}")
    for epoch in (0, 1):
        saved = _flat_tensors(torch.load(
            out2 / f"checkpoint-{epoch}" / "train_state.pt",
            map_location="cpu", weights_only=True))
        want = snapshots[epoch]
        assert saved.keys() == want.keys() and saved, epoch
        same = all(torch.equal(saved[k], want[k]) for k in want)
        log(f"  epoch {epoch}: the background writer's checkpoint-{epoch} "
            f"{'equals' if same else 'DIFFERS from'} the synchronous "
            f"snapshot, {len(want)} tensors; the main thread spent "
            f"{snapshots[epoch, 'submit_s'] * 1e3:.0f} ms on it, the "
            f"writer thread {snapshots[epoch, 'write_s'] * 1e3:.0f} ms on "
            f"the writes")
        assert same, epoch
    trace = json.loads((out2 / "profile" / "trace.json").read_text())
    kernels = {e.get("name", "") for e in trace["traceEvents"]
               if e.get("cat") == "kernel"}
    found = {label: any(n in k for n in names for k in kernels)
             for label, names in PROFILE_KERNELS.items()}
    log(f"  --profile_steps 2: {len(trace['traceEvents'])} trace events, "
        f"{len(kernels)} distinct kernels; ours found: {found}")
    assert all(found.values()), found
    report["resume"] = dict(steps=steps, wall_s=wall, launches=counts,
                            expected_launches=expect,
                            checkpoint_submit_ms=[
                                snapshots[e, "submit_s"] * 1e3
                                for e in (0, 1)],
                            checkpoint_write_ms=[
                                snapshots[e, "write_s"] * 1e3
                                for e in (0, 1)],
                            trace_events=len(trace["traceEvents"]))
    del state
    torch.cuda.empty_cache()

    # a real SIGTERM to the CLI's own process, after its first step
    out3 = WORK / "drill_sigterm"
    cmd = [sys.executable, "-m", "vae_tagger_tpu_torch.train.train_full",
           *_drill_argv(art, json_path, out3, "--num_epochs", "3")]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, sent = [], False
    try:
        for line in proc.stdout:
            lines.append(line)
            if not sent and line.startswith("Epoch: 0, Step: 0"):
                proc.send_signal(_signal.SIGTERM)
                sent = True
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines)
    saved = torch.load(out3 / "interrupt_checkpoint" / "train_state.pt",
                       map_location="cpu", weights_only=True)
    log(f"  SIGTERM after the first step of the CLI's process: exit {rc} "
        f"in {time.perf_counter() - t0:.1f} s, interrupt checkpoint at "
        f"step {saved['step']}")
    assert sent and rc == 0, text[-3000:]
    assert "SIGTERM received" in text and "skipping final evaluation" in text
    assert 1 <= saved["step"] < n_train
    assert not (out3 / "optimal_thresholds.json").exists()
    report["sigterm"] = dict(exit=rc, step=int(saved["step"]))
    return report


# --------------------------------------------------------------------------
# data parallelism (parallel/mesh.py)
# --------------------------------------------------------------------------

DP_RES = 512          # (b): two fp32 ranks at 1024px would not fit beside
DP_BATCH = 2          # the parent; the global batch of (b), one a rank
DP_IMAGES = 9         # (a): an odd batch, so the pad row runs
DP_LOSS = dict(reconstruction_weight=0.5, kl_weight=0.1)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_replicas(art):
    """(a) ``TaggerEngine.with_devices`` over every local GPU, two replicas
    on cuda:0 where there is one: a batch of 9 at 1024px against one
    engine's classify of the same batch (SERVE_TOL), with the exact
    launches of one batch a chunk."""
    import numpy as np
    import torch
    from PIL import Image
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine
    from vae_tagger_tpu_torch.ops import backend

    n = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(n)] if n > 1
               else [torch.device(DEVICE)] * 2)
    paths = sorted(Path(art["images"]).glob("*.png"))
    pixels = np.stack([np.asarray(Image.open(p).convert("RGB"))
                       for p in (paths * 2)[:DP_IMAGES]])
    out = {"devices": [str(d) for d in devices]}
    for key, precision in (("fp32", "no"), ("bf16", "bf16")):
        engine = TaggerEngine.load(
            vae_checkpoint=art["vae"], decoder_checkpoint=art["decoder"],
            tags_csv_path=art["tags"], vae_config_path=art["config"],
            mixed_precision=precision, device=DEVICE)
        replicated = engine.with_devices(devices)
        want = engine.classify(pixels)
        replicated.classify(pixels)  # first call: cuDNN's choice per shape
        torch.cuda.synchronize()
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        got = replicated.classify(pixels)
        wall = time.perf_counter() - t0
        counts = backend.launch_counts()
        expect = _expected(ENCODE_LAUNCHES[key], len(devices))
        assert counts == expect, (key, counts, expect)
        assert got.shape == want.shape and np.isfinite(got).all()
        worst = float(np.abs(got - want).max())
        log(f"  (a) {len(devices)} replicas ({', '.join(map(str, devices))}"
            f"), {key}: a batch of {DP_IMAGES} at {RES}px in chunks of "
            f"{-(-DP_IMAGES // len(devices))} (pad rows dropped), "
            f"{wall * 1e3:.1f} ms (host clock), against one engine "
            f"{worst:.3e} (gate {SERVE_TOL[key]:.0e}); launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        assert worst <= SERVE_TOL[key], (key, worst)
        out[key] = dict(max_abs_diff=worst, wall_ms=wall * 1e3,
                        launches=counts, chunks=len(devices))
        del engine, replicated
        torch.cuda.empty_cache()
    return out


def _dp_data(art, json_path):
    """data.json of the first 3 images: one step of a global batch of 2
    and one validation image (the 90/10 split)."""
    data = json.loads(Path(json_path).read_text())
    path = WORK / "dp_data.json"
    path.write_text(json.dumps(dict(list(data.items())[:3]), indent=1))
    return str(path)


def _dp_step(art, dp_json):
    """One fp32 full-loss ``FullSteps.train_step`` (reconstruction and KL
    on, the head in train mode: BatchNorm on batch statistics, dropout)
    at DP_RES on the global batch of DP_BATCH, this process's slice of it
    under a process group, then a second, warm step that is timed.
    Returns (the first step's metrics, its averaged gradients on the host,
    the BatchNorm running statistics after it, its launches, the warm
    step's ms, the all-reduce ms of each update)."""
    import torch
    from vae_tagger_tpu_torch.data.dataset import TaggedImageDataset
    from vae_tagger_tpu_torch.data.loader import DataLoader
    from vae_tagger_tpu_torch.infer.engine import build_decoder
    from vae_tagger_tpu_torch.io.checkpoints import load_decoder, load_vae
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.parallel import mesh
    from vae_tagger_tpu_torch.train import state as state_mod
    from vae_tagger_tpu_torch.train.state import Optimizer, TrainState
    from vae_tagger_tpu_torch.train.steps import FullSteps

    dev = torch.device(DEVICE)
    vae = load_vae(art["vae"], art["config"], with_decoder=True)
    head = load_decoder(build_decoder(NUM_TAGS, True, None, 16, SEED + 1),
                        art["decoder"])
    vae, head = vae.to(dev).train(), head.to(dev).train()
    dataset = TaggedImageDataset(json_path=dp_json, tags_csv_path=art["tags"],
                                 resolution=DP_RES, seed=SEED,
                                 return_triplets=True)
    loader = DataLoader(dataset, DP_BATCH, shuffle=False, num_workers=2,
                        seed=SEED, indices=[0, 1],
                        process_index=mesh.process_index(),
                        process_count=mesh.process_count())
    batch = next(iter(loader))
    named = ([(f"vae.{n}", p) for n, p in vae.named_parameters()]
             + [(f"head.{n}", p) for n, p in head.named_parameters()])
    opt = Optimizer([p for _, p in named], lambda count: 1e-4)
    grads, reduce_ms = {}, []

    def record_then_step(step=opt.adamw.step):
        if not grads:
            grads.update({n: p.grad.detach().float().cpu() for n, p in named
                          if p.grad is not None})
        step()

    def timed_reduce(tensors, reduce=state_mod.all_reduce_mean_):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(tensors)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    opt.adamw.step = record_then_step
    reduce = state_mod.all_reduce_mean_
    state_mod.all_reduce_mean_ = timed_reduce
    try:
        steps = FullSteps(LossConfig(**DP_LOSS), use_simplified=False,
                          compute_dtype=torch.float32, seed=SEED)
        state = TrainState(vae=vae, decoder=head, optimizer=opt)
        backend.reset_launch_counts()
        metrics = steps.train_step(state, batch, 0)
        torch.cuda.synchronize()
        launches = backend.launch_counts()
        bn = {k: v.detach().cpu().clone()
              for k, v in head.state_dict().items()
              if k.startswith("feature_compress.1.running")}
        t0 = time.perf_counter()
        steps.train_step(state, batch, 1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        state_mod.all_reduce_mean_ = reduce
    metrics = {k: v.item() for k, v in metrics.items() if v.dim() == 0}
    return metrics, grads, bn, launches, step_ms, reduce_ms


def _dp_cli_argv(art, dp_json, out, *flags):
    return ["--json_path", dp_json, "--tags_csv_path", art["tags"],
            "--vae_checkpoint", art["vae"], "--vae_config_path",
            art["config"], "--decoder_checkpoint", art["decoder"],
            "--output_dir", str(out), "--resolution", str(DP_RES),
            "--num_epochs", "1", "--mixed_precision", "no",
            "--no_simplified_loss", "--lr_warmup_steps", "0",
            "--save_steps", "1", "--logging_steps", "1", "--num_workers",
            "2", "--seed", str(SEED), "--device", DEVICE, *flags]


def dp_gloo_rank(workdir):
    """A rank of (b), under ``torch.distributed.run``: its own gloo group
    on cuda:0 (NCCL refuses two ranks on one GPU), which the trainer's
    ``initialize_distributed`` keeps; the step of ``_dp_step``, then one
    epoch of the train_full CLI into an output directory of this rank's
    own (a write by rank 1 would show)."""
    import datetime

    import torch
    import torch.distributed as dist
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.train import train_full

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://",
                            timeout=datetime.timedelta(minutes=5))
    workdir = Path(workdir)
    rank = dist.get_rank()
    art = json.loads((workdir / "art.json").read_text())
    dp_json = str(workdir / "dp_data.json")
    metrics, grads, bn, launches, step_ms, reduce_ms = _dp_step(art, dp_json)
    grad_mb = sum(g.numel() * 4 for g in grads.values()) / 2**20
    if rank == 0:
        torch.save({"metrics": metrics, "grads": grads, "bn": bn},
                   workdir / "rank0_step.pt")
    del grads
    torch.cuda.empty_cache()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    train_full.main(_dp_cli_argv(art, dp_json, workdir / f"rank{rank}",
                                 "--train_batch_size", "1"))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    (workdir / f"rank{rank}.json").write_text(json.dumps(dict(
        launches=launches, step_ms=step_ms, reduce_ms=reduce_ms,
        grad_mb=grad_mb, cli_s=cli_s,
        cli_launches=backend.launch_counts())))
    dist.barrier()
    dist.destroy_process_group()


def dp_nccl(workdir):
    """(c), in a child process under a one-rank launcher environment: one
    bf16 train_full step at 1024px without a process group, the same step
    again (the control), then ``initialize_distributed`` (NCCL) and the
    same step on the NCCL path (the gradient all-reduce, the averaged
    metrics), which must be bit-equal to the first: the loss, every
    parameter after the update, the BatchNorm running statistics; then
    ``gather_to_host`` through the group."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from vae_tagger_tpu_torch.data.dataset import TaggedImageDataset
    from vae_tagger_tpu_torch.data.loader import DataLoader
    from vae_tagger_tpu_torch.infer.engine import build_decoder
    from vae_tagger_tpu_torch.io.checkpoints import load_decoder, load_vae
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.parallel import mesh
    from vae_tagger_tpu_torch.train.state import Optimizer, TrainState
    from vae_tagger_tpu_torch.train.steps import FullSteps

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    workdir = Path(workdir)
    art = json.loads((workdir / "art.json").read_text())
    dataset = TaggedImageDataset(json_path=art["json_path"],
                                 tags_csv_path=art["tags"], resolution=RES,
                                 seed=SEED, return_triplets=True)

    def step():
        dev = torch.device(DEVICE)
        vae = load_vae(art["vae"], art["config"], with_decoder=True)
        head = load_decoder(build_decoder(NUM_TAGS, True, None, 16, SEED + 1,
                                          dtype=torch.bfloat16),
                            art["decoder"])
        vae, head = vae.to(dev).train(), head.to(dev).train()
        loader = DataLoader(dataset, 1, shuffle=False, num_workers=2,
                            seed=SEED, indices=[0],
                            process_index=mesh.process_index(),
                            process_count=mesh.process_count())
        state = TrainState(vae=vae, decoder=head, optimizer=Optimizer(
            [*vae.parameters(), *head.parameters()], lambda count: 1e-4))
        steps = FullSteps(LossConfig(triplet_weight=1.0), seed=SEED,
                          compute_dtype=torch.bfloat16)
        batch = next(iter(loader))
        backend.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = steps.train_step(state, batch, 0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = {f"vae.{k}": v.detach().cpu().clone()
                 for k, v in vae.state_dict().items()}
        after.update({f"head.{k}": v.detach().cpu().clone()
                      for k, v in head.state_dict().items()})
        out = (metrics["loss"].item(), after, backend.launch_counts(), ms)
        del state, vae, head
        torch.cuda.empty_cache()
        return out

    def same(a, b):
        return a[0] == b[0] and all(torch.equal(a[1][k], b[1][k])
                                    for k in a[1])

    plain = step()
    control = step()
    device = mesh.initialize_distributed(DEVICE)
    backend_name = dist.get_backend()
    nccl = step()
    probs = np.random.default_rng(0).random((3, 5)).astype(np.float32)
    gathered = mesh.gather_to_host(torch.from_numpy(probs).to(device))
    mask = mesh.gather_to_host(np.array([True, False, True]))
    dist.destroy_process_group()
    (workdir / "nccl.json").write_text(json.dumps(dict(
        device=str(device), backend=backend_name, loss_plain=plain[0],
        loss_nccl=nccl[0],
        control_bit_equal=same(plain, control),
        nccl_bit_equal=same(plain, nccl),
        tensors=len(plain[1]), launches=nccl[2], plain_ms=plain[3],
        control_ms=control[3], nccl_ms=nccl[3],
        gather_ok=bool(np.array_equal(gathered, probs)
                       and np.array_equal(mask, [True, False, True])))))


def _run_child(cmd, env, log_path, timeout):
    """Run a child of this phase, its output to ``log_path``; fatal with
    the tail of that output on a non-zero exit."""
    import os

    with open(log_path, "w", encoding="utf-8") as f:
        proc = subprocess.run(cmd, cwd=ROOT, stdout=f,
                              stderr=subprocess.STDOUT, timeout=timeout,
                              env=dict(os.environ, PYTHONPATH=str(ROOT),
                                       **env))
    if proc.returncode != 0:
        tail = Path(log_path).read_text()[-4000:]
        raise AssertionError(f"{cmd[2:5]} exited {proc.returncode}:\n{tail}")


def phase_data_parallel(art, json_path):
    """Data parallelism (parallel/mesh.py), each check fatal: (a) engine
    replicas in one process; (b) two gloo ranks on cuda:0 against one
    process's step on the same global batch, rank 0 alone writing, its
    checkpoint resumed in one process; (c) one NCCL rank, bit-equal to the
    run without a process group.  The times of (b) are two ranks sharing
    one card: no scaling figure."""
    import gc

    import torch
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.train import train_full

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log("data parallelism:")
    report = {"replicas": _dp_replicas(art)}
    work = WORK / "dp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dp_json = _dp_data(art, json_path)
    shutil.copy(dp_json, work / "dp_data.json")
    (work / "art.json").write_text(json.dumps({**art,
                                               "json_path": json_path}))
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two gloo ranks on cuda:0
    t0 = time.perf_counter()
    _run_child([sys.executable, "-m", "torch.distributed.run",
                "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
                "--master_port", str(_free_port()),
                str(ROOT / "chip_smoke.py"),
                "--dp-gloo-rank", str(work)], {}, work / "gloo.log", 600)
    gloo_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in (0, 1)]
    dp = torch.load(work / "rank0_step.pt", weights_only=False)
    assert not (work / "rank1").exists(), "rank 1 wrote files"
    for name in ("optimal_thresholds.json", "evaluation_results.csv",
                 "training_history.json", "checkpoint-0/train_state.pt",
                 "decoder/pytorch_model.bin"):
        assert (work / "rank0" / name).exists(), name
    for r, rank in enumerate(ranks):
        expect = _expected(VAE_STEP_LAUNCHES["fp32"], 1)
        assert rank["launches"] == expect, (r, rank["launches"], expect)
    metrics, grads, bn, _, step_ms, _ = _dp_step(art, dp_json)
    # the gradient gate's rule: absolute where the gradient is zero in
    # exact arithmetic (a key projection's bias; in train mode also the
    # conv bias before the head's BatchNorm), relative elsewhere
    worst, errs = ("", 0.0), []
    for n, g in grads.items():
        diff, norm = (dp["grads"][n] - g).norm().item(), g.norm().item()
        absolute = (norm < ZERO_GRAD_NORM
                    or n == "head.feature_compress.0.bias")
        err = diff if absolute else diff / norm
        errs.append(err)
        worst = max(worst, (n, err), key=lambda t: t[1])
    loss_rel = abs(dp["metrics"]["loss"] - metrics["loss"]) / abs(
        metrics["loss"])
    bn_err = max((dp["bn"][k] - v).abs().max().item() for k, v in bn.items())
    log(f"  (b) two gloo ranks on cuda:0 (two ranks sharing one card: no "
        f"scaling figure): fp32 full-loss step at {DP_RES}px, global batch "
        f"{DP_BATCH}: loss {dp['metrics']['loss']:.7f} vs one process "
        f"{metrics['loss']:.7f} (rel {loss_rel:.2e}, gate 1e-5); "
        f"{len(grads)} gradients, worst {worst[0]} {worst[1]:.3e}, median "
        f"{sorted(errs)[len(errs) // 2]:.3e} (gate 1e-3); BatchNorm running "
        f"statistics {bn_err:.2e} apart; metrics {dp['metrics']}")
    log(f"  (b) times (host clock; two ranks sharing one card, no scaling "
        f"figure): the warm step of each rank {ranks[0]['step_ms']:.1f} / "
        f"{ranks[1]['step_ms']:.1f} ms, of one process at batch {DP_BATCH} "
        f"{step_ms:.1f} ms; the gradient all-reduce "
        f"({ranks[0]['grad_mb']:.0f} MiB, gloo through the host) "
        f"{' / '.join(f'{ms:.1f}' for ms in ranks[0]['reduce_ms'])} ms an "
        f"update (first, warm); the two-rank CLI epoch "
        f"{ranks[0]['cli_s']:.1f} s, the launcher {gloo_s:.1f} s")
    assert set(grads) == set(dp["grads"]) and len(grads) > 0
    assert loss_rel <= 1e-5, loss_rel
    assert all(e <= 1e-3 for e in errs), worst
    assert bn_err <= 1e-5 * max(v.abs().max().item() for v in bn.values())
    del grads, dp
    gc.collect()
    torch.cuda.empty_cache()
    resumed = work / "resumed"
    backend.reset_launch_counts()
    train_full.main(_dp_cli_argv(art, dp_json, resumed, "--train_batch_size",
                                 str(DP_BATCH), "--resume_from",
                                 str(work / "rank0" / "checkpoint-0")))
    saved = torch.load(resumed / "checkpoint-0" / "train_state.pt",
                       weights_only=True)
    assert saved["step"] == 2, saved["step"]
    log(f"  (b) rank 0's checkpoint-0 resumed in one process: step "
        f"{saved['step']}; rank 1 wrote nothing")
    report["gloo"] = dict(loss_rel=loss_rel, worst_param=worst[0],
                          worst_err=worst[1],
                          median_err=sorted(errs)[len(errs) // 2],
                          bn_err=bn_err, one_process_step_ms=step_ms,
                          ranks=ranks, launcher_s=gloo_s,
                          launches=ranks[0]["launches"])
    gc.collect()
    torch.cuda.empty_cache()

    # (c) one NCCL rank
    t0 = time.perf_counter()
    _run_child([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-nccl",
                str(work)], dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                                 MASTER_ADDR="127.0.0.1",
                                 MASTER_PORT=str(_free_port()),
                                 CUBLAS_WORKSPACE_CONFIG=":4096:8"),
               work / "nccl.log", 600)
    nccl = json.loads((work / "nccl.json").read_text())
    log(f"  (c) one NCCL rank on {nccl['device']}: bf16 step at {RES}px "
        f"bit-equal to the run without a process group: "
        f"{nccl['nccl_bit_equal']} ({nccl['tensors']} tensors, loss "
        f"{nccl['loss_nccl']!r} vs {nccl['loss_plain']!r}; the control, the "
        f"same step twice without a group: {nccl['control_bit_equal']}); "
        f"step {nccl['nccl_ms']:.1f} ms (the control {nccl['control_ms']:.1f}"
        f", the first, cold {nccl['plain_ms']:.1f}); "
        f"gather {nccl['gather_ok']}; the child "
        f"{time.perf_counter() - t0:.1f} s")
    assert nccl["backend"] == "nccl", nccl["backend"]
    assert nccl["nccl_bit_equal"], nccl
    assert nccl["gather_ok"], nccl
    expect = _expected(TRAIN_STEP_LAUNCHES["bf16"], 1)
    assert nccl["launches"] == expect, (nccl["launches"], expect)
    report["nccl"] = nccl
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  data parallelism: {report['seconds']:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    return report


# --------------------------------------------------------------------------
# spatial parallelism: height slabs, one controller
# --------------------------------------------------------------------------

SPATIAL_SHARDS = 2
# the mid-block attention of a 1024px image over two slabs: each slab's
# queries against every slab's keys and values
SPATIAL_SKV = (RES // 8) ** 2
SPATIAL_SQ = SPATIAL_SKV // SPATIAL_SHARDS
# encoder sites of phase_spatial (b), a batch of 4 at 1024px cut in two:
# (H=W of the stage, Cin, Cout, variant, Cres); each slab H/2 rows plus
# one halo row (both slabs of two touch one image edge)
SPATIAL_B_CASES = [(1024, 128, 128, "residual", 128),
                   (512, 256, 256, "shortcut", 128),
                   (128, 512, 512, "residual", 512)]
SPATIAL_TOL = {"fp32": 1e-5, "bf16": 1e-2}  # probabilities, as served


def _spatial_launches(per_forward, n=SPATIAL_SHARDS):
    """The launches of a path run on n height slabs: every kernel n times,
    and at each kernel-A site of the forward the slab's own stats pass
    besides (A's apply pass then runs from the combined statistics).  In a
    train step A's apply pass also runs once a fused conv's backward
    (_gn_backward_launches), which has no stats pass."""
    out = {k: n * v for k, v in per_forward.items()}
    a_sites = per_forward.get("group_norm_silu", 0)
    if per_forward.get("group_norm_silu_bwd"):
        a_sites -= sum(v for k, v in per_forward.items()
                       if k.startswith("gn_silu_conv3x3"))
    out["group_stats"] = out.get("group_stats", 0) + n * a_sites
    return out


def _spatial_devices():
    """Every local GPU, or two names of cuda:0 on a one-card machine."""
    import torch

    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [torch.device("cuda", 0)] * SPATIAL_SHARDS)


def phase_spatial_kernels(results):
    """(a) C', C'' at B=4 and D', E', D'', E'' at B=3 at the rectangular
    shapes of a 1024px image over two slabs (Sq=8,192, Skv=16,384), each
    against its plain version, timed beside its bound and SDPA on the same
    shapes; (b) B', B'' and the stats pass on halo-extended slabs at three
    encoder sites of a batch of 4, B fed given statistics (the form the
    slabs use), and A's apply pass from given statistics on a mid-block
    slab, against their plain versions on the same slab."""
    import torch
    import torch.nn.functional as F
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.attention import (
        bwd_delta,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )
    from vae_tagger_tpu_torch.ops.conv import gn_silu_conv3x3_from_stats
    from vae_tagger_tpu_torch.ops.normalization import (
        group_norm_silu_from_stats,
        group_stats_plain,
        group_stats_with_grad,
    )

    log(f"spatial kernels: the attention at Sq={SPATIAL_SQ}, "
        f"Skv={SPATIAL_SKV} (a {RES}px image over {SPATIAL_SHARDS} slabs), "
        f"B and the stats pass on halo-extended slabs")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    d, sq, skv = 512, SPATIAL_SQ, SPATIAL_SKV
    parts = {"dq": flash_attention_bwd_dq, "dkv": flash_attention_bwd_dkv}
    for b, names in ((BATCH, ("flash_attention_fwd_tc",
                              "flash_attention_fwd_tf32x3")),
                     (TRAIN_ROWS, ("flash_attention_bwd_dq_tc",
                                   "flash_attention_bwd_dkv_tc",
                                   "flash_attention_bwd_dq_tf32x3",
                                   "flash_attention_bwd_dkv_tf32x3"))):
        q, do = (_rnd_dev(g, b, sq, d) for _ in range(2))
        k, v = (_rnd_dev(g, b, skv, d) for _ in range(2))
        ins = {dt: tuple(t.to(dt) for t in (q, k, v, do))
               for dt in (torch.float32, torch.bfloat16)}
        label = f"B={b} Sq={sq} Skv={skv}"
        io_bytes = 2 * b * sq * d + 2 * b * skv * d
        lib_bwd = {}
        if b == TRAIN_ROWS:
            with backend.backend("torch"):
                o, lse = flash_attention_fwd(q, k, v)
            delta = bwd_delta(o, do)
            for dt in (torch.bfloat16, torch.float32):
                with torch.enable_grad():
                    qb, kb, vb = (t.detach().requires_grad_()
                                  for t in ins[dt][:3])
                    out = sdpa(qb, kb, vb)
                    dob = ins[dt][3][:, None]
                    lib_bwd[dt] = time_ms(lambda: torch.autograd.grad(
                        out, (qb, kb, vb), dob, retain_graph=True))
                    del out, qb, kb, vb
        for name in names:
            dt = torch.bfloat16 if name.endswith("_tc") else torch.float32
            esize = 2.0 if dt == torch.bfloat16 else 4.0
            chk = Check(name, ("bf16",) if dt == torch.bfloat16 else
                        ("fp32",))
            if "fwd" in name:
                def op(dt_):
                    return flash_attention_fwd(*ins[dt_][:3])

                library = (lambda dt=dt: sdpa(*ins[dt][:3]))
                nbytes = esize * io_bytes + 4.0 * b * sq
                flops = 4.0 * b * sq * skv * d
                calls = 1
            else:
                part = "dq" if "_dq_" in name else "dkv"

                def op(dt_, part=part):
                    out = parts[part](*ins[dt_], lse, delta)
                    return out if isinstance(out, tuple) else (out,)

                library = None
                nbytes = (esize * io_bytes + 4.0 * 2 * b * sq
                          + esize * (b * sq * d if part == "dq"
                                     else 2 * b * skv * d))
                flops = (6.0 if part == "dq" else 8.0) * b * sq * skv * d
                calls = 1 if part == "dq" else 2
            chk.run(label, op)
            ms, plain_ms, lib_ms = time_kernel(op, dt, library)
            lib_ms = lib_bwd.get(dt, lib_ms) if library is None else lib_ms
            b_ms, b_by = (bound(nbytes, flops) if dt == torch.bfloat16
                          else _fp32_bounds(nbytes, flops)[1])
            log(f"  {name} {label}: {ms:.3f} ms (bound {b_ms:.3f}, "
                f"{b_ms / ms:.1%}, {b_by}), plain {plain_ms:.3f}, SDPA "
                f"{'(its whole backward) ' if library is None else ''}"
                f"{lib_ms:.3f}")
            _tile_bucket(results, name, label, chk, key="spatial", ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, launches_per_call=calls)
        del q, k, v, do, ins
        torch.cuda.empty_cache()

    conv_dts = {"gn_silu_conv3x3_tc": torch.bfloat16,
                "gn_silu_conv3x3_tf32x3": torch.float32}
    for hw, cin, cout, variant, cres in SPATIAL_B_CASES:
        rows = hw // SPATIAL_SHARDS
        ext = _rnd_dev(g, BATCH, rows + 1, hw, cin)  # the slab + a halo row
        mean, meansq = group_stats_plain(ext[:, :rows], GROUPS)
        gs = _rnd_dev(g, cin, scale=0.2, shift=1.0)
        gb = _rnd_dev(g, cin, scale=0.1)
        k = _rnd_dev(g, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        b = _rnd_dev(g, cout, scale=0.1)
        res = _rnd_dev(g, BATCH, rows + 1, hw, cres)
        sck = (_rnd_dev(g, cres, cout, scale=cres ** -0.5)
               if variant == "shortcut" else None)
        scb = _rnd_dev(g, cout, scale=0.1) if variant == "shortcut" else None
        xs, rs = _both(ext), _both(res)
        own = _both(ext[:, :rows].contiguous())
        del ext, res
        label = (f"N={BATCH} ({rows}+1)x{hw} {cin}->{cout} {variant}"
                 + (f" Cres={cres}" if variant == "shortcut" else ""))

        def op(dt):
            return gn_silu_conv3x3_from_stats(xs[dt], mean, meansq, gs, gb, k,
                                              b, rs[dt], sck, scb)

        m = BATCH * (rows + 1) * hw
        k_dim = 9 * cin + (cres if variant == "shortcut" else 0)
        for name, dt in conv_dts.items():
            chk = Check(name, ("bf16",) if dt == torch.bfloat16 else
                        ("fp32",))
            chk.run(label, op)
            w_oihw = k.to(dt).permute(3, 2, 0, 1).contiguous()
            sc_oihw = (None if sck is None
                       else sck.to(dt).t()[:, :, None, None].contiguous())

            def library(dt=dt, w_oihw=w_oihw, sc_oihw=sc_oihw):
                y = F.silu(F.group_norm(xs[dt].permute(0, 3, 1, 2), GROUPS,
                                        gs.to(dt), gb.to(dt), 1e-6))
                out = F.conv2d(y, w_oihw, b.to(dt), padding=1)
                if sc_oihw is not None:
                    return out + F.conv2d(rs[dt].permute(0, 3, 1, 2),
                                          sc_oihw, scb.to(dt))
                return out + rs[dt].permute(0, 3, 1, 2)

            ms, plain_ms, lib_ms = time_kernel(op, dt, library)
            esize = 2.0 if dt == torch.bfloat16 else 4.0
            nbytes = esize * (m * cin + m * cout + m * cres + k_dim * cout)
            flops = 2.0 * m * k_dim * cout
            b_ms, b_by = (bound(nbytes, flops) if dt == torch.bfloat16
                          else _fp32_bounds(nbytes, flops)[1])
            log(f"  {name} {label}: {ms:.3f} ms (bound {b_ms:.3f}, "
                f"{b_ms / ms:.1%}, {b_by}), plain {plain_ms:.3f}, cuDNN "
                f"(GN+SiLU+conv) {lib_ms:.3f}")
            _tile_bucket(results, name, label, chk, key="spatial", ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, launches_per_call=1)
        if hw == RES // 8:  # the mid-block: A's apply pass on the slab
            a_label = f"N={BATCH} {rows}x{hw} C={cin} (a slab, given stats)"
            chk = Check("group_norm_silu")

            def aop(dt):
                return group_norm_silu_from_stats(own[dt], mean, meansq, gs,
                                                  gb, apply_silu=False)

            chk.run(a_label, aop)
            for dt in (torch.bfloat16, torch.float32):
                xd = own[dt]

                def library(xd=xd, dt=dt):
                    return F.group_norm(xd.permute(0, 3, 1, 2), GROUPS,
                                        gs.to(dt), gb.to(dt), 1e-6)

                ms, plain_ms, lib_ms = time_kernel(aop, dt, library)
                b_ms = 2 * xd.numel() * xd.element_size() / PEAK_BYTES * 1e3
                key = str(dt).removeprefix("torch.")
                log(f"  group_norm_silu {a_label} {key}: {ms:.3f} ms (bound "
                    f"{b_ms:.3f}, {b_ms / ms:.0%}), plain {plain_ms:.3f}, "
                    f"F.group_norm {lib_ms:.3f}")
                _tile_bucket(results, "group_norm_silu", f"{a_label} {key}",
                             chk, key="spatial", ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms,
                             bound_by="bytes", launches_per_call=1)
        chk = Check("group_stats")
        s_label = f"N={BATCH} {rows}x{hw} C={cin} (a slab's own rows)"

        def sop(dt):
            return group_stats_with_grad(own[dt], GROUPS)

        chk.run(s_label, sop)
        for dt in (torch.bfloat16, torch.float32):
            xd = own[dt]

            def library(xd=xd):
                return torch.var_mean(
                    xd.view(BATCH, rows * hw, GROUPS, -1).float(),
                    dim=(1, 3), correction=0)

            ms, plain_ms, lib_ms = time_kernel(sop, dt, library)
            b_ms = xd.numel() * xd.element_size() / PEAK_BYTES * 1e3
            key = str(dt).removeprefix("torch.")
            log(f"  group_stats {s_label} {key}: {ms:.3f} ms (bound "
                f"{b_ms:.3f}, {b_ms / ms:.0%}), plain {plain_ms:.3f}, "
                f"var_mean {lib_ms:.3f}")
            _tile_bucket(results, "group_stats", f"{s_label} {key}", chk,
                         key="spatial", ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by="bytes",
                         launches_per_call=1)
        del xs, rs, own
        torch.cuda.empty_cache()


def _device_ms_by_kind(fn, *args):
    """Device ms of ``fn(*args)`` by kind, from the second of two profiled
    calls: the port's kernels, the copies (the halo's ``torch.cat``,
    ``contiguous()`` of a cropped slab, the casts) and the rest (cuDNN
    convs, cuBLAS, elementwise); then the port's kernels by name
    (``_kernel_breakdown``) and the top kernels as (ms, calls, name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ours = ("conv3x3_tc_kernel", "conv3x3_tf32x3_kernel", "flash_fwd_tc",
            "flash_fwd_tf32x3", "gn_stats_vec_kernel", "gn_apply_vec_kernel",
            "gn_bwd_reduce_kernel", "gn_bwd_apply_kernel")
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
    kinds = {"kernels": 0.0, "copies": 0.0, "rest": 0.0}
    top = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if evt.device_type != DeviceType.CUDA or us <= 0 or _annotation(evt):
            continue
        name = evt.key.lower()
        kind = ("kernels" if any(k in name for k in ours) else
                "copies" if ("copy" in name or "catarray" in name)
                else "rest")
        kinds[kind] += us / 1e3
        top.append((round(us / 1e3, 3), evt.count, evt.key[:80]))
    by_kernel, _, _ = _kernel_breakdown(prof)
    return dict(kinds, by_kernel=by_kernel, top=sorted(top, reverse=True)[:12])


def _spatial_classify(art, devices):
    """(c) ``TaggerEngine.with_spatial`` over ``devices`` at 1024px, fp32
    and bf16, batch 4 and batch 1, against one engine on the same pixels:
    fp32 latents MSE < 1e-10, probabilities within SPATIAL_TOL, the exact
    launches of a batch on the slabs; steady times (host clock) of both."""
    import numpy as np
    import torch
    from PIL import Image
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine
    from vae_tagger_tpu_torch.ops import backend

    paths = sorted(Path(art["images"]).glob("*.png"))[:BATCH]
    pixels = np.stack([np.asarray(Image.open(p).convert("RGB"))
                       for p in paths])
    out = {}
    for key, precision in (("fp32", "no"), ("bf16", "bf16")):
        engine = TaggerEngine.load(
            vae_checkpoint=art["vae"], decoder_checkpoint=art["decoder"],
            tags_csv_path=art["tags"], vae_config_path=art["config"],
            mixed_precision=precision, device=DEVICE)
        sp = engine.with_spatial(devices)
        for b in (BATCH, 1):
            px = pixels[:b]
            want_lat, want = engine.encode_and_classify(px)
            sp.classify(px)  # first call: cuDNN's choice per slab shape
            torch.cuda.synchronize()
            backend.reset_launch_counts()
            got_lat, got = sp.encode_and_classify(px)
            counts = backend.launch_counts()
            expect = _expected(_spatial_launches(ENCODE_LAUNCHES[key]), 1)
            assert counts == expect, (key, b, counts, expect)
            assert got.shape == want.shape and np.isfinite(got).all()
            mse = float(np.mean((got_lat.astype(np.float64) - want_lat)
                                ** 2))
            worst = float(np.abs(got - want).max())
            iters = 5 if key == "fp32" else 10
            times = {}
            for name, eng in (("one engine", engine), ("spatial", sp)):
                eng.classify(px)
                t0 = time.perf_counter()
                for _ in range(iters):
                    eng.classify(px)
                times[name] = (time.perf_counter() - t0) / iters * 1e3
            if key == "bf16" and b == BATCH:
                breakdown = {name: _device_ms_by_kind(eng.classify, px)
                             for name, eng in (("one engine", engine),
                                               ("spatial", sp))}
                log(f"  (c) device ms of one bf16 batch of {b} by kind: "
                    f"{breakdown}")
                out["bf16_breakdown_ms"] = breakdown
            log(f"  (c) spatial classify over {len(devices)} slabs "
                f"({', '.join(map(str, devices))}), {key}, batch {b}: "
                f"latents MSE {mse:.3e} against one engine, probabilities "
                f"{worst:.3e} (gate {SPATIAL_TOL[key]:.0e}); "
                f"{times['spatial']:.1f} ms a batch against one engine's "
                f"{times['one engine']:.1f} (host clock, {iters} batches; "
                f"slabs on one card: no scaling figure); launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            if key == "fp32":
                assert mse < 1e-10, mse
            assert worst <= SPATIAL_TOL[key], (key, b, worst)
            out[f"{key}_b{b}"] = dict(latents_mse=mse, max_abs_diff=worst,
                                      spatial_ms=times["spatial"],
                                      one_engine_ms=times["one engine"],
                                      launches=counts)
        del engine, sp
        torch.cuda.empty_cache()
    return out


def _spatial_step(art, batch, devices, trainer):
    """(d) one ``train_full`` step (simplified loss, the head in train
    mode) or (e) one ``train_vae`` step (the KL optimized: the anchor's
    decode on the slabs too) at 1024px, batch 1, unsharded and over
    ``devices`` on the same batch and generator: the loss (fp32 rel 1e-5,
    bf16 1e-2), every fp32 gradient (rel 1e-3; absolute where the
    unsharded norm is below ZERO_GRAD_NORM, and for the conv bias before
    the head's train-mode BatchNorm), the exact launches on the slabs; the
    steady step (host clock) and peak memory of both.  train_vae runs the
    gradient gate in fp32 and its steady step in bf16."""
    import torch
    from vae_tagger_tpu_torch.infer.engine import build_decoder
    from vae_tagger_tpu_torch.io.checkpoints import load_decoder, load_vae
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.parallel.spatial import SpatialMesh
    from vae_tagger_tpu_torch.train.state import TrainState, build_optimizer
    from vae_tagger_tpu_torch.train.steps import (
        FullSteps,
        VaeSteps,
        batch_to_device,
        step_generators,
    )

    dev = torch.device(DEVICE)
    mesh = SpatialMesh(devices)
    full = trainer == "train_full"
    per_step = (TRAIN_STEP_LAUNCHES if full else VAE_STEP_LAUNCHES)
    out = {}
    for key, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        vae = load_vae(art["vae"], art["config"],
                       with_decoder=not full).to(dev).train()
        head = (load_decoder(build_decoder(NUM_TAGS, True, None, 16,
                                           SEED + 1, dtype=dt),
                             art["decoder"]).to(dev).train()
                if full else None)
        params = ([(f"vae.{n}", p) for n, p in vae.named_parameters()]
                  + ([(f"head.{n}", p) for n, p in head.named_parameters()]
                     if full else []))
        opt = build_optimizer([p for _, p in params], lambda count: 1e-6)
        state = TrainState(vae=vae, decoder=head, optimizer=opt)

        def make_steps(sp, dt=dt):
            if full:
                return FullSteps(LossConfig(triplet_weight=1.0,
                                            use_focal_loss=False),
                                 compute_dtype=dt, seed=SEED, spatial=sp)
            return VaeSteps(LossConfig(reconstruction_weight=1.0),
                            use_simplified=False, compute_dtype=dt,
                            seed=SEED, spatial=sp)

        runs = {}
        for mode in ("plain", "spatial"):
            steps = make_steps(mesh if mode == "spatial" else None)
            for _, p in params:
                p.grad = None
            g, g_recon = step_generators(dev, SEED, 7)
            torch.cuda.synchronize()
            backend.reset_launch_counts()
            total, _, _ = steps.forward_losses(
                state, batch_to_device(batch, dev), g, train=True,
                recon_generator=g_recon)
            total.backward()
            torch.cuda.synchronize()
            counts = backend.launch_counts()
            if mode == "spatial":
                expect = _expected(_spatial_launches(per_step[key]), 1)
                assert counts == expect, (trainer, key, counts, expect)
            runs[mode] = dict(loss=total.item(), counts=counts, grads=(
                {n: p.grad.detach().clone() for n, p in params
                 if p.grad is not None} if key == "fp32" else None))
        loss_rel = abs(runs["spatial"]["loss"] - runs["plain"]["loss"]) / abs(
            runs["plain"]["loss"])
        rep = dict(loss=runs["spatial"]["loss"],
                   loss_unsharded=runs["plain"]["loss"], loss_rel=loss_rel,
                   launches=runs["spatial"]["counts"])
        said = (f"loss {runs['spatial']['loss']:.7f} vs unsharded "
                f"{runs['plain']['loss']:.7f} (rel {loss_rel:.2e}, gate "
                f"{1e-5 if key == 'fp32' else 1e-2:.0e})")
        assert loss_rel <= (1e-5 if key == "fp32" else 1e-2), said
        if key == "fp32":
            gp, gs = runs["plain"]["grads"], runs["spatial"]["grads"]
            assert set(gp) == set(gs) and gp, (len(gp), len(gs))
            worst, errs = ("", 0.0), []
            for n, gt in gp.items():
                diff, norm = (gs[n] - gt).norm().item(), gt.norm().item()
                absolute = (norm < ZERO_GRAD_NORM
                            or n == "head.feature_compress.0.bias")
                err = diff if absolute else diff / norm
                errs.append(err)
                worst = max(worst, (n, err), key=lambda t: t[1])
            median = sorted(errs)[len(errs) // 2]
            said += (f"; {len(gp)} gradients, worst {worst[0]} "
                     f"{worst[1]:.3e}, median {median:.3e} (gate 1e-3)")
            assert all(e <= 1e-3 for e in errs), worst
            rep.update(gradients=len(gp), worst_param=worst[0],
                       worst_err=worst[1], median_err=median)
            del gp, gs
        for r in runs.values():
            r.pop("grads")
        if full or key == "bf16":
            iters = 3
            for mode in ("plain", "spatial"):
                steps = make_steps(mesh if mode == "spatial" else None)
                step_s, peak, _ = _steady_step(state, batch, dt, iters,
                                               8000, steps)
                rep[f"step_ms_{mode}"] = step_s * 1e3
                rep[f"peak_mem_bytes_{mode}"] = peak
            said += (f"; steady step {rep['step_ms_spatial']:.1f} ms, peak "
                     f"{rep['peak_mem_bytes_spatial'] / 2**30:.2f} GiB, "
                     f"against unsharded {rep['step_ms_plain']:.1f} ms, "
                     f"{rep['peak_mem_bytes_plain'] / 2**30:.2f} GiB (host "
                     f"clock, {iters} steps; slabs on one card: no scaling "
                     f"figure)")
        log(f"  ({'d' if full else 'e'}) spatial {trainer} step over "
            f"{len(devices)} slabs, {key}: {said}; launches "
            f"{ {k: v for k, v in rep['launches'].items() if v} }")
        out[key] = rep
        del state, vae, head, opt, params, runs
        torch.cuda.empty_cache()
    return out


def _spatial_clis(art, json_path, devices, train_history):
    """(f) the infer CLI and train_full's CLI in this process with
    ``parallel.mesh.local_devices`` giving ``devices``: --spatial_parallel
    against the runs without it (--no_data_parallel; train_full's fp32 CLI
    of phase_training), the JSON within SPATIAL_TOL["fp32"], the training
    loss within rel 1e-4 and the validation loss within rel 5e-2 (it reads
    the head's BatchNorm in eval mode after a conv bias whose gradient is
    zero in exact arithmetic: AdamW turns either run's rounding noise into
    +-lr steps there); exact launches on the slabs."""
    import numpy as np
    import torch
    from vae_tagger_tpu_torch.infer.__main__ import main as infer_main
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.parallel import mesh

    local = mesh.local_devices
    mesh.local_devices = lambda device="cuda": list(devices)
    try:
        results = {}
        for mode, flag in (("plain", "--no_data_parallel"),
                           ("spatial", "--spatial_parallel")):
            out_dir = WORK / f"infer_{mode}"
            torch.cuda.synchronize()
            backend.reset_launch_counts()
            t0 = time.perf_counter()
            infer_main(["--vae_checkpoint", art["vae"], "--vae_config_path",
                        art["config"], "--decoder_checkpoint",
                        art["decoder"], "--image_path", art["images"],
                        "--tags_csv_path", art["tags"], "--output_dir",
                        str(out_dir), "--resolution", str(RES),
                        "--batch_size", str(BATCH), "--num_workers", "4",
                        "--confidence_threshold", "0", "--device", DEVICE,
                        flag])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = backend.launch_counts()
            results[mode] = json.loads(
                (out_dir / "classification_results.json").read_text())
            results[mode + "_wall_s"] = wall
            results[mode + "_launches"] = counts
        n_batches = -(-N_IMAGES // BATCH)
        expect = _expected(_spatial_launches(ENCODE_LAUNCHES["fp32"]),
                           n_batches)
        assert results["spatial_launches"] == expect, (
            results["spatial_launches"], expect)
        assert set(results["spatial"]) == set(results["plain"])
        worst = 0.0
        for k, v in results["plain"].items():
            a = {t["tag"]: t["confidence"] for t in v["predicted_tags"]}
            b = {t["tag"]: t["confidence"] for t in
                 results["spatial"][k]["predicted_tags"]}
            assert a.keys() == b.keys() and len(a) == NUM_TAGS
            worst = max(worst, max(abs(a[t] - b[t]) for t in a))
        log(f"  (f) infer CLI --spatial_parallel (fp32, {N_IMAGES} images in "
            f"batches of {BATCH}): confidences within {worst:.3e} of the "
            f"run without it (gate {SPATIAL_TOL['fp32']:.0e} and one step of "
            f"the JSON's 4-decimal rounding); "
            f"{results['spatial_wall_s']:.2f} s against "
            f"{results['plain_wall_s']:.2f} s (load included)")
        assert worst <= SPATIAL_TOL["fp32"] + 1e-4, worst
        _, _, rep = _train_cli(art, json_path, "no",
                               flags=("--spatial_parallel",),
                               shards=len(devices))
        hist = rep["history"]
        train_rel = float(np.max(np.abs(
            np.subtract(hist["train_loss"], train_history["train_loss"]))
            / np.abs(train_history["train_loss"])))
        val_rel = float(np.max(np.abs(
            np.subtract(hist["val_loss"], train_history["val_loss"]))
            / np.abs(train_history["val_loss"])))
        log(f"  (f) train_full CLI --spatial_parallel (fp32): train loss "
            f"rel {train_rel:.2e} (gate 1e-4), validation loss rel "
            f"{val_rel:.2e} (gate 5e-2) against phase_training's fp32 run")
        assert train_rel <= 1e-4 and val_rel <= 5e-2, (train_rel, val_rel)
    finally:
        mesh.local_devices = local
    return dict(infer=dict(max_abs_diff=worst,
                           launches=results["spatial_launches"],
                           wall_s=results["spatial_wall_s"],
                           wall_s_plain=results["plain_wall_s"]),
                train_full=dict(rep, train_loss_rel=train_rel,
                                val_loss_rel=val_rel))


def phase_spatial(art, json_path, batch, train_fp32_history):
    """Height-sharded spatial parallelism (parallel/spatial.py) over two
    slabs, on cuda:0 twice where there is one card, each check fatal: (c)
    spatial classify, (d) a train_full step, (e) a train_vae step, (f) the
    infer and train_full CLIs.  Slabs on one card run one after the other:
    no time here is a scaling figure."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    devices = _spatial_devices()
    log(f"spatial parallelism over {len(devices)} slabs "
        f"({', '.join(map(str, devices))}):")
    report = {"devices": [str(d) for d in devices]}
    report["classify"] = _spatial_classify(art, devices)
    report["train_full_step"] = _spatial_step(art, batch, devices,
                                              "train_full")
    report["train_vae_step"] = _spatial_step(art, batch, devices,
                                             "train_vae")
    report["cli"] = _spatial_clis(art, json_path, devices, train_fp32_history)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  spatial parallelism: {report['seconds']:.1f} s")
    return report


def _tree_steps(art, json_path):
    """The steady train_full and train_vae steps at 1024px, batch 1, bf16
    and fp32, on fresh states of the seeded weights (host clock and peak
    memory, _steady_step; one profiled step's device ms by kernel,
    _profiled_step): what --measure-tree measures of a tree's package."""
    import torch
    from vae_tagger_tpu_torch.data.dataset import TaggedImageDataset
    from vae_tagger_tpu_torch.data.loader import DataLoader
    from vae_tagger_tpu_torch.infer.engine import build_decoder
    from vae_tagger_tpu_torch.io.checkpoints import load_decoder, load_vae
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.train.state import TrainState, build_optimizer
    from vae_tagger_tpu_torch.train.steps import FullSteps, VaeSteps

    dataset = TaggedImageDataset(json_path, art["tags"], RES, seed=SEED)
    batch = next(iter(DataLoader(dataset, 1, shuffle=False, num_workers=1)))
    out = {}
    for trainer, runs in (("train_full", (("bf16", torch.bfloat16, 10),
                                          ("fp32", torch.float32, 4))),
                          ("train_vae", (("bf16", torch.bfloat16, 5),
                                         ("fp32", torch.float32, 3)))):
        full = trainer == "train_full"
        for key, dt, iters in runs:
            vae = load_vae(art["vae"], art["config"],
                           with_decoder=not full).to(DEVICE).train()
            head = (load_decoder(build_decoder(NUM_TAGS, True, None, 16,
                                               SEED + 1, dtype=dt),
                                 art["decoder"]).to(DEVICE).train()
                    if full else None)
            params = list(vae.parameters()) + (list(head.parameters())
                                               if full else [])
            state = TrainState(vae=vae, decoder=head,
                               optimizer=build_optimizer(params,
                                                         lambda count: 1e-6))
            steps = (FullSteps(LossConfig(triplet_weight=1.0,
                                          use_focal_loss=False),
                               compute_dtype=dt, seed=SEED) if full else
                     VaeSteps(LossConfig(**VAE_LOSS), compute_dtype=dt,
                              seed=SEED))
            step_s, peak, _ = _steady_step(state, batch, dt, iters, 1000,
                                           steps)
            log(f"  {trainer} {key}: steady step {step_s * 1e3:.1f} ms "
                f"(host clock, {iters} steps), peak {peak / 2**30:.2f} GiB")
            prof = _profiled_step(steps, state, batch, 2000)
            out[f"{trainer}|{key}"] = dict(
                step_ms=step_s * 1e3, peak_gib=peak / 2**30,
                device_ms=prof["profiled_step_ms"],
                device_ms_by_kernel=prof["device_ms_by_kernel"])
            del state, vae, head, params, steps
            torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the Wan 2.1 VAE's encoder
# --------------------------------------------------------------------------

def _wan_b_cases(n=TILE_BATCH):
    """The distinct shapes of the fused residual-block branch in the
    published Wan 2.1 encoder (``default_wan_vae_config``) at a batch of n
    at RES: (N, side, Cin, Cout, variant, Cres); each block's first conv
    takes no residual, its second the block's input, through the 1x1
    shortcut where the width changes.  The mid block's two blocks repeat
    the last stage's shapes."""
    from vae_tagger_tpu_torch.core.config import default_wan_vae_config

    cfg = default_wan_vae_config()
    dims, side, cases = cfg.widths, RES, []
    for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(cfg.num_res_blocks):
            cases.append((n, side, c_in, c_out, "plain", None))
            cases.append((n, side, c_out, c_out,
                          "shortcut" if c_in != c_out else "residual", c_in))
            c_in = c_out
        if i != len(dims) - 2:
            side //= 2
    return list(dict.fromkeys(cases))


def phase_wan():
    """The Wan 2.1 VAE's kernels at the shapes its bf16 benchmark cell
    (a batch of 8 at 1024px) gives them, each against its plain version in
    the dtypes it runs, and one 1024px encode through the model:

    - the RMS stats pass, and the apply pass with SiLU, on the largest
      activation, 8 x 1024^2 x 96, in both dtypes;
    - the residual-block branch (``rms_silu_conv3x3``) at each of the
      encoder's distinct shapes (``_wan_b_cases``: 96, 192 and 384
      channels, plain, with the residual, with the shortcut): the stats
      pass and B' in its RMS mode in bf16, the stats and apply passes and
      B'' in fp32;
    - C' and C'' at B=8, S=16,384, D=384 (the mid block's attention);
    - ``AutoencoderKLWan`` at the published widths, seeded, on one 1024px
      image: the moments of the kernel path against the plain path
      (fp32 within 1e-4 relative, bf16 within 4x the plain bf16 path's own
      error) and the exact launches of one encode in each dtype, the counts
      reset just before it.

    Every kernel is timed beside its bound (the products, or the bytes
    moved once; the stats pass's read of x counted with B')."""
    import torch
    from vae_tagger_tpu_torch.core.config import default_wan_vae_config
    from vae_tagger_tpu_torch.models.autoencoder_kl_wan import (
        AutoencoderKLWan,
    )
    from vae_tagger_tpu_torch.nn.blocks import seeded_init_
    from vae_tagger_tpu_torch.ops import backend
    from vae_tagger_tpu_torch.ops.attention import flash_attention_fwd
    from vae_tagger_tpu_torch.ops.conv import rms_silu_conv3x3
    from vae_tagger_tpu_torch.ops.normalization import (
        rms_norm_silu,
        rms_norm_silu_apply,
        rms_norm_stats,
    )

    log(f"the Wan 2.1 VAE: the RMS passes, B'/B'' in the RMS mode at the "
        f"encoder's shapes and C'/C'' at D=384, a batch of {TILE_BATCH} at "
        f"{RES}^2; one {RES}px encode")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    out = {"kernels": {}}
    dts = {"fp32": torch.float32, "bf16": torch.bfloat16}

    def timed(key, label, chk, fn, nbytes, flops=0.0):
        """Time fn(dt) in each dtype that chk ran, beside its bound."""
        row = {k: max(r[k] for r in chk.rows if k in r)
               for k in ("rel_err_fp32", "rel_err_bf16")
               if any(k in r for r in chk.rows)}
        for name in chk.dtypes:
            dt = dts[name]
            ms = time_ms(lambda: fn(dt))
            esize = 2.0 if dt == torch.bfloat16 else 4.0
            b_ms, b_by = (bound(nbytes(esize), flops) if name == "bf16"
                          else _fp32_bounds(nbytes(esize), flops)[1])
            log(f"  {key} {label} {name}: {ms:.3f} ms (bound {b_ms:.3f}, "
                f"{b_ms / ms:.1%}, {b_by})")
            row[f"ms_{name}"], row[f"bound_ms_{name}"] = ms, b_ms
        out["kernels"].setdefault(key, {})[label] = row

    # the RMS passes on the stem's activation
    n, side, c = TILE_BATCH, RES, default_wan_vae_config().base_dim
    m = n * side * side
    x = _both(_rnd_dev(g, n, side, side, c))
    gamma = _rnd_dev(g, c, scale=0.2, shift=1.0)
    label = f"N={n} {side}x{side} C={c}"
    chk = Check("rms_norm_stats", tol32=1e-5)
    chk.run(label, lambda dt: rms_norm_stats(x[dt]))
    timed("rms_norm_stats", label, chk, lambda dt: rms_norm_stats(x[dt]),
          lambda e: e * m * c + 4.0 * m)
    chk = Check("rms_norm_silu", tol32=1e-5)
    chk.run(label, lambda dt: rms_norm_silu(x[dt], gamma))
    r = {dt: rms_norm_stats(x[dt]) for dt in x}
    timed("rms_norm_silu", f"{label} (apply pass)", chk,
          lambda dt: rms_norm_silu_apply(x[dt], r[dt], gamma),
          lambda e: 2 * e * m * c + 4.0 * m)
    del x, r
    torch.cuda.empty_cache()

    # the residual-block branch at each distinct shape
    for n, side, cin, cout, variant, cres in _wan_b_cases():
        m = n * side * side
        x = _rnd_dev(g, n, side, side, cin)
        gamma = _rnd_dev(g, cin, scale=0.2, shift=1.0)
        k = _rnd_dev(g, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        b = _rnd_dev(g, cout, scale=0.1)
        res = sck = scb = None
        if variant != "plain":
            res = _rnd_dev(g, n, side, side, cres)
        if variant == "shortcut":
            sck = _rnd_dev(g, cres, cout, scale=cres ** -0.5)
            scb = _rnd_dev(g, cout, scale=0.1)
        xs, rs = _both(x), _both(res)
        del x, res
        label = (f"N={n} {side}x{side} {cin}->{cout} {variant}"
                 + (f" Cres={cres}" if variant == "shortcut" else ""))

        def op(dt):
            return rms_silu_conv3x3(xs[dt], gamma, k, b, rs[dt], sck, scb)

        chk = Check("rms_silu_conv3x3")
        chk.run(label, op)
        k_dim = 9 * cin + (cres if variant == "shortcut" else 0)
        c_res = cres or 0
        timed("rms_silu_conv3x3", label, chk, op,
              lambda e: e * (2 * m * cin + m * cout + m * c_res
                             + k_dim * cout),
              2.0 * m * k_dim * cout)
        del xs, rs
        torch.cuda.empty_cache()

    # the mid block's attention
    b, s, d = TILE_BATCH, (RES // 8) ** 2, default_wan_vae_config().widths[-1]
    qkv = [_both(_rnd_dev(g, b, s, d)) for _ in range(3)]
    label = f"B={b} S={s} D={d}"

    def attn(dt):
        return flash_attention_fwd(*(t[dt] for t in qkv))

    chk = Check("flash_attention_fwd")
    chk.run(label, attn)
    timed("flash_attention_fwd", label, chk, attn,
          lambda e: e * 4 * b * s * d + 4.0 * b * s, 4.0 * b * s * s * d)
    del qkv
    torch.cuda.empty_cache()

    # one encode through the model (gammas and biases off their identity
    # start), and its launches
    vae = seeded_init_(AutoencoderKLWan(default_wan_vae_config()), SEED)
    gp = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, p in sorted(vae.named_parameters()):
            if name.endswith(("gamma", "bias")):
                p.add_(0.05 * torch.randn(p.shape, generator=gp))
    vaes = {torch.float32: vae.to(DEVICE).eval()}
    vaes[torch.bfloat16] = copy.deepcopy(vaes[torch.float32]).bfloat16()
    pixels = _rnd_dev(g, 1, RES, RES, 3).clamp_(-1.0, 1.0)

    def encode(dt):
        post = vaes[dt].encode(pixels.to(dt))
        return torch.cat([post.mean, post.logvar], -1)

    chk = Check("AutoencoderKLWan.encode")
    chk.run(f"N=1 {RES}x{RES}", encode)
    expect = {"bf16": {"rms_norm_stats": 22, "rms_norm_silu": 2,
                       "rms_silu_conv3x3_tc": 20,
                       "flash_attention_fwd_tc": 1},
              "fp32": {"rms_norm_stats": 22, "rms_norm_silu": 22,
                       "gn_silu_conv3x3_tf32x3": 20,
                       "flash_attention_fwd_tf32x3": 1}}
    out["encode"] = {"rows": chk.rows, "launches": {}}
    for name, want in expect.items():
        torch.cuda.synchronize()
        backend.reset_launch_counts()
        encode(dts[name])
        torch.cuda.synchronize()
        counts = {k: v for k, v in backend.launch_counts().items() if v}
        log(f"  launches of one {RES}px Wan encode, {name}: {counts}")
        assert counts == want, (name, counts, want)
        out["encode"]["launches"][name] = counts
    del vae, vaes, pixels
    torch.cuda.empty_cache()
    return out


def measure_tree(tree, steps=None):
    """--measure-tree: kernel F's site times (_f_site_times) and, with
    ``steps`` (JSON of the artifacts and data.json), the steady steps
    (_tree_steps), of the port's package in the checkout ``tree``; prints
    them as one JSON line, the last."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from vae_tagger_tpu_torch.ops import _build

    where = Path(_build.__file__).resolve()
    assert where.is_relative_to(Path(tree).resolve()), where
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    report = {"tree": str(tree)}
    with torch.no_grad():
        report["f"] = _f_site_times(torch.Generator().manual_seed(SEED + 15))
    if steps is not None:
        report["steps"] = _tree_steps(**json.loads(steps))
    print(json.dumps(report), flush=True)


def phase_parent_compare(art, json_path, parent_tree):
    """With --parent-tree: kernel F's site times and the steady train_full
    and train_vae steps, bf16 and fp32, of the parent tree's package and of
    this one's, each in a child process (_tree_child) on the same card, in
    the order parent, this, this, parent."""
    log(f"parent tree {parent_tree} against this tree: kernel F and the "
        f"training steps, in the order parent, this, this, parent")
    runs = []
    for tree in (parent_tree, ROOT, ROOT, parent_tree):
        rep = _tree_child(tree, dict(art=art, json_path=json_path))
        runs.append(dict(rep, which="this" if tree == ROOT else "parent"))

    def both(part, key, metric):
        return {w: [r[part][key][metric] for r in runs if r["which"] == w]
                for w in ("parent", "this")}

    summary = {}
    for part, metrics in (("f", ("ms", "device_ms")),
                          ("steps", ("step_ms", "device_ms", "peak_gib"))):
        for key in runs[0][part]:
            for metric in metrics:
                got = both(part, key, metric)
                summary[f"{part}|{key}|{metric}"] = got
                log(f"  {part} {key} {metric}: parent "
                    f"{', '.join(f'{v:.3f}' for v in got['parent'])}; this "
                    f"{', '.join(f'{v:.3f}' for v in got['this'])}")
    return dict(runs=runs, summary=summary)


def _image_size(path):
    """(width, height) of an image file, from its header."""
    from PIL import Image

    with Image.open(path) as im:
        return tuple(im.size)


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
    parser.add_argument("--dp-gloo-rank", type=Path, default=None,
                        help="run as a rank of phase_data_parallel's two "
                             "gloo ranks (under torch.distributed.run)")
    parser.add_argument("--dp-nccl", type=Path, default=None,
                        help="run phase_data_parallel's one NCCL rank")
    parser.add_argument("--parent-tree", type=Path, default=None,
                        help="a checkout of the parent commit (e.g. a git "
                             "archive under build/archive/): time its "
                             "kernel F beside this tree's, and its training "
                             "steps (phase_parent_compare)")
    parser.add_argument("--measure-tree", type=Path, default=None,
                        help="only measure the port's package in this "
                             "checkout (a child process of --parent-tree)")
    parser.add_argument("--steps", default=None,
                        help="with --measure-tree: JSON of the artifacts "
                             "and data.json; time the training steps too")
    args = parser.parse_args()
    if args.measure_tree is not None:
        return measure_tree(args.measure_tree, args.steps)
    if args.device_breakdown:
        print(json.dumps(device_breakdown()))
        return
    if args.dp_gloo_rank is not None:
        return dp_gloo_rank(args.dp_gloo_rank)
    if args.dp_nccl is not None:
        return dp_nccl(args.dp_nccl)

    t_start = time.perf_counter()
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
        phase_decoder_kernels(g, results)
    torch.cuda.empty_cache()
    with torch.no_grad():
        phase_kernel_de(g, results)
        torch.cuda.empty_cache()
        phase_kernel_f(g, results, args.parent_tree)
    torch.cuda.empty_cache()
    report["autograd"] = phase_autograd(g)
    torch.cuda.empty_cache()
    report["main_path"] = phase_main_path()
    report["training"], art, json_path, train_out, batch = phase_training()
    torch.cuda.empty_cache()
    report["decode"] = phase_decode_gate(art)
    report["train_vae"] = phase_train_vae(art, json_path, batch)
    report["full_loss"], _ = phase_full_loss(art, json_path)
    report["eval_latents"] = phase_eval_and_latents(art, json_path,
                                                    train_out)
    torch.cuda.empty_cache()
    with torch.no_grad():  # the backward's library call takes a graph
        phase_tile_bucket_kernels(results)
    torch.cuda.empty_cache()
    report["tiled"] = phase_tiled(art)
    torch.cuda.empty_cache()
    report["train_decoder"] = phase_train_decoder(art, json_path)
    torch.cuda.empty_cache()
    report["buckets"] = phase_buckets(art)
    torch.cuda.empty_cache()
    report["serve"] = phase_serve(art)
    report["attention_maps"] = phase_attention_maps(art)
    report["drills"] = phase_drills(art, json_path)
    torch.cuda.empty_cache()
    report["data_parallel"] = phase_data_parallel(art, json_path)
    torch.cuda.empty_cache()
    with torch.no_grad():  # the backward's library call takes a graph
        phase_spatial_kernels(results)
    torch.cuda.empty_cache()
    report["spatial"] = phase_spatial(art, json_path, batch,
                                      report["training"]["fp32"]["history"])
    torch.cuda.empty_cache()
    with torch.inference_mode():
        report["wan"] = phase_wan()
    if args.parent_tree is not None:
        log(f"{time.perf_counter() - t_start:.1f} s before the parent "
            f"tree's phase")
        torch.cuda.empty_cache()
        report["parent_compare"] = phase_parent_compare(art, json_path,
                                                        args.parent_tree)
    shutil.rmtree(WORK, ignore_errors=True)
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
                   report["training"]["gradient_gate"]["launches"],
               "decode_bf16": report["decode"]["launches_bf16"],
               "decode_fp32": report["decode"]["launches_fp32"],
               "train_vae_bf16": report["train_vae"]["bf16"]["launches"],
               "train_vae_fp32": report["train_vae"]["fp32"]["launches"],
               "train_vae_grad_gate_fp32":
                   report["train_vae"]["gradient_gate"]["launches"],
               "train_full_full_loss_bf16": report["full_loss"]["launches"],
               "eval_fp32": report["eval_latents"]["eval"]["launches"],
               "latents_fp32":
                   report["eval_latents"]["latents"]["launches"],
               **{f"tiled_{what}_{k}": report["tiled"][f"{what}_{k}"][
                   "launches"] for what in ("encode", "decode")
                  for k in ("fp32", "bf16")},
               "latents_tiled_fp32":
                   report["tiled"]["latents_cli"]["launches"],
               "reconstruct_tiled_fp32":
                   report["tiled"]["reconstruct_cli"]["launches"],
               **{f"train_decoder_{k}": report["train_decoder"][k][
                   "launches"] for k in ("bf16", "fp32", "yuv420_bf16")},
               **{f"{t}_bucketed_{k}": report["buckets"][f"{t}_{k}"][
                   "launches"] for t in ("train_full", "train_vae")
                  for k in ("bf16", "fp32")},
               "grad_gate_bucketed_fp32":
                   report["buckets"]["gradient_gate"]["launches"],
               **{f"infer_yuv420_{k}": report["buckets"][
                   f"infer_yuv420_{k}"]["launches"]
                  for k in ("bf16", "fp32")},
               **{f"serve_{k}": report["serve"][k]["launches"]
                  for k in ("fp32", "bf16")},
               **{f"attention_maps_{k}": report["attention_maps"][k][
                   "launches"] for k in ("fp32", "bf16")},
               "drill_bf16": report["drills"]["drill"]["launches"],
               "drill_resume_bf16": report["drills"]["resume"]["launches"],
               **{f"dp_replicas_{k}": report["data_parallel"]["replicas"][
                   k]["launches"] for k in ("fp32", "bf16")},
               "dp_gloo_rank0_step_fp32":
                   report["data_parallel"]["gloo"]["launches"],
               "dp_nccl_step_bf16":
                   report["data_parallel"]["nccl"]["launches"],
               **{f"spatial_classify_{k}": report["spatial"]["classify"][k][
                   "launches"] for k in ("fp32_b4", "fp32_b1", "bf16_b4",
                                         "bf16_b1")},
               **{f"spatial_{t}_step_{k}": report["spatial"][f"{t}_step"][k][
                   "launches"] for t in ("train_full", "train_vae")
                  for k in ("bf16", "fp32")},
               "spatial_infer_cli_fp32":
                   report["spatial"]["cli"]["infer"]["launches"],
               "spatial_train_full_cli_fp32":
                   report["spatial"]["cli"]["train_full"]["launches"]}
    kernels = []
    for name, meta in KERNELS.items():
        r = results[name]
        path = KERNEL_PATH.get(name, "train_bf16")
        launches = by_path[path][name]
        assert launches > 0, f"{name} was not launched on its path {path}"
        # the spatial path of each kernel: the train_full step over the
        # slabs in the kernel's dtype
        spatial_path = ("spatial_train_full_step_fp32"
                        if name.endswith("_tf32x3") else
                        "spatial_train_full_step_bf16")
        spatial_launches = by_path[spatial_path][name]
        assert spatial_launches > 0, (name, spatial_path)
        kernels.append(dict(
            name=name, **meta, launches=launches, path=path,
            spatial_path=spatial_path, spatial_launches=spatial_launches,
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
               if k in r},
            **({"decoder": {k: v for k, v in r["decoder"].items()
                            if k != "cases"}} if "decoder" in r else {}),
            **({"tile_bucket": r["tile_bucket"]} if "tile_bucket" in r
               else {}),
            **({"spatial": r["spatial"]} if "spatial" in r else {})))
    report["kernel_line"] = kernels
    report["wall_s"] = time.perf_counter() - t_start
    log(f"{report['wall_s']:.1f} s in all")
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
