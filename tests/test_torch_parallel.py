"""The port's data parallelism on the CPU (``vae_tagger_tpu_torch/parallel``),
against the JAX package's SPMD data parallelism on the virtual CPU devices
that conftest.py pins:

- the loader's per-process slices and global real-row counts against the
  JAX loader's, on the same sampler;
- ``initialize_distributed``'s environment contract (nothing, a
  half-configured launcher, a ``LOCAL_RANK`` past the devices), after
  tests/test_distributed.py; ``auto_data_parallel``; the noise layout of
  ``draw_global``; the config helpers against the JAX package's;
- ``TaggerEngine.with_devices`` over two CPU replicas against the JAX
  engine's ``with_mesh`` over two CPU devices, an odd batch (atol 1e-5);
- two gloo ranks (subprocesses) taking one full-loss ``train_full`` step
  with the head's BatchNorm in train mode and dropout on: loss, metrics,
  every gradient and the BatchNorm running statistics against the JAX
  package's ``make_full_steps`` step over a 2-device data mesh on the
  global batch (rel 1e-4) and against the port's one-process step on the
  global batch (rel 1e-5).  The noise cannot match across frameworks, so
  numpy draws it for the global batch on both sides (the port's draw
  functions and flax's Dropout are patched, the JAX posterior's sample
  too), and flax's BatchNorm takes its two-pass variance, as the port
  does (tests/test_torch_train_decoder.py says why).  The latents keep
  FLUX's 16 channels: with 4, the head's BatchNorm has 2 channels, and
  its train-mode backward then multiplies the two frameworks' fp32
  rounding of the encoder about 250-fold in the gradients before it
  (measured: 1e-6 relative noise on the VAE's weights moves them by
  2.5e-4; at 16 channels by at most 2.8e-5, and the JAX step is 4.4e-6
  away);
- two gloo ranks running the ``train_full`` CLI for an epoch: only rank 0
  writes, the threshold search and evaluation equal the one-process
  run's, and rank 0's checkpoint resumes in one process.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_tagger_tpu_torch.core.config import (
    AttentionDecoderConfig,
    default_flux_vae_config,
)
from vae_tagger_tpu_torch.parallel import mesh

ROOT = Path(__file__).resolve().parents[1]
LATENT = 16
TINY = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
            latent_channels=LATENT)
RES, B, TAGS = 32, 4, 6          # B: the global batch of the step test
DROPOUT_SHAPES = [(B, 2, 64, 64), (B, 1024), (B, 512), (B, 256)]
CFG = dict(use_focal_loss=True, reconstruction_weight=0.5, kl_weight=0.2)


# --------------------------------------------------------------------------
# helpers without a process group
# --------------------------------------------------------------------------

class _Items:
    """A dataset stand-in: only its length matters to the sampler."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("rank", [0, 1])
def test_local_slice_and_global_count_match_jax(rank):
    from vae_tagger_tpu.data.loader import DataLoader as JaxLoader
    from vae_tagger_tpu_torch.data.loader import DataLoader

    kw = dict(batch_size=4, shuffle=True, seed=3, indices=list(range(11)),
              process_index=rank, process_count=2)
    port, jax_loader = DataLoader(_Items(11), **kw), JaxLoader(_Items(11),
                                                               **kw)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        got = [port._local_slice(i, m) for i, m in port.sampler]
        want = [jax_loader._local_slice(i, m) for i, m in jax_loader.sampler]
        assert got == want and len(got) == 3
        assert [c for _, _, c in got].count(3) == 1  # the padded batch
    with pytest.raises(ValueError, match="divide"):
        DataLoader(_Items(11), 3, process_index=rank, process_count=2)


@pytest.mark.parametrize("env", [
    {},
    {"WORLD_SIZE": "2"},
    {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
     "MASTER_PORT": "29500"},
    "past_devices"])
def test_initialize_distributed_env_contract(env, monkeypatch):
    """No launcher variable: nothing happens.  Some but not all: fatal
    (the peers would wait forever).  A LOCAL_RANK at or past the visible
    GPUs: fatal (each process owns one GPU)."""
    for k in mesh.LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    if env == "past_devices":
        env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": "29500",
               "LOCAL_RANK": str(torch.cuda.device_count())}
        match, device = "visible GPUs", "cuda"
    else:
        match, device = "refusing to run single-process", "cpu"
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if not env:
        assert mesh.initialize_distributed("cpu") == torch.device("cpu")
    else:
        with pytest.raises(RuntimeError, match=match):
            mesh.initialize_distributed(device)
    assert not torch.distributed.is_initialized()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.is_main_process()


def test_auto_data_parallel_contract(monkeypatch, capsys):
    assert mesh.auto_data_parallel(4, device="cpu") == (None, 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    devices, batch = mesh.auto_data_parallel(4, what="serving",
                                             batch_label="default max_batch")
    assert devices == [torch.device("cuda", i) for i in range(3)]
    assert batch == 24
    assert ("data-parallel serving over 3 devices (default max_batch 24)"
            in capsys.readouterr().out)
    assert mesh.auto_data_parallel(40)[1] == 40
    assert mesh.auto_data_parallel(4, enabled=False) == (None, 4)
    assert mesh.auto_data_parallel(4, device="cuda:1") == (None, 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.auto_data_parallel(4) == (None, 4)


@pytest.mark.parametrize("parts", [1, 3])
def test_draw_global_takes_this_ranks_rows(parts, monkeypatch):
    """Two ranks' draws, concatenated block by block, are the global draw;
    one process draws the local shape itself."""
    glob = torch.arange(2 * 6 * parts, dtype=torch.float32).reshape(-1, 2)
    draw = lambda shape: glob[:shape[0]]  # noqa: E731
    assert torch.equal(mesh.draw_global(draw, (3 * parts, 2), parts),
                       glob[:3 * parts])
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    rows = []
    for r in (0, 1):
        monkeypatch.setattr(mesh, "process_index", lambda r=r: r)
        rows.append(mesh.draw_global(draw, (3 * parts, 2), parts))
    blocks = [torch.cat([rows[r][j * 3:(j + 1) * 3] for r in (0, 1)])
              for j in range(parts)]
    assert torch.equal(torch.cat(blocks), glob)


def test_gather_and_means_without_a_group():
    x = np.arange(6).reshape(3, 2)
    assert np.array_equal(mesh.gather_to_host(x), x)
    assert np.array_equal(mesh.gather_to_host(torch.from_numpy(x)), x)
    v = torch.tensor([1.0, 2.0, 4.0])
    assert mesh.global_mean(v) == v.mean() and mesh.global_sum(v) is v
    metrics = {"loss": v.sum()}
    assert mesh.mean_over_processes(metrics) is metrics


@pytest.mark.parametrize("resolution", [256, 512, 1024])
def test_config_helpers_match_jax(resolution):
    from vae_tagger_tpu.core import config as jax_config
    from vae_tagger_tpu_torch import core

    assert core.get_vae_latent_info(resolution, 4, 4) == \
        jax_config.get_vae_latent_info(resolution, 4, 4)
    assert core.get_vae_latent_info(resolution) == \
        jax_config.get_vae_latent_info(resolution)
    port = core.default_sd_vae_config(sample_size=resolution)
    want = jax_config.default_sd_vae_config(sample_size=resolution)
    assert port.to_json_dict() == want.to_json_dict()


# --------------------------------------------------------------------------
# engine replicas
# --------------------------------------------------------------------------

def _engine_artifacts(root):
    """A tiny VAE and an attention head written by the JAX package."""
    import jax
    import jax.numpy as jnp

    from vae_tagger_tpu.core.config import default_flux_vae_config as jcfg
    from vae_tagger_tpu.io import save_decoder_bin, save_vae_pretrained
    from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL
    from vae_tagger_tpu.models.taggers import AttentionClassificationDecoder

    cfg = jcfg(**TINY)
    params = jax.jit(AutoencoderKL(cfg).init)(
        {"params": jax.random.key(0)}, jnp.zeros((1, 64, 64, 3)),
        jax.random.key(1))["params"]
    save_vae_pretrained(_perturb(params, 1), cfg, f"{root}/vae")
    head = AttentionClassificationDecoder(latent_channels=16, num_classes=TAGS)
    variables = jax.jit(head.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(2)}, jnp.zeros((1, 8, 8, 16)),
        deterministic=True)
    save_decoder_bin(_perturb(variables["params"], 4), _stats(8),
                     f"{root}/decoder.bin")
    Path(f"{root}/tags.csv").write_text(
        "name,count\n" + "".join(f"tag_{i},{i}\n" for i in range(TAGS)))
    return dict(vae_checkpoint=f"{root}/vae/diffusion_pytorch_model"
                ".safetensors", vae_config_path=f"{root}/vae/config.json",
                decoder_checkpoint=f"{root}/decoder.bin",
                tags_csv_path=f"{root}/tags.csv")


def _perturb(tree, seed, scale=0.05):
    import jax

    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a, np.float32)
        + (rng.normal(size=np.shape(a)) * scale).astype(np.float32)
        for a in leaves])


def _stats(c):
    rng = np.random.default_rng(3)
    return {"feature_compress_1": {
        "mean": (rng.normal(size=(c,)) * 0.1).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)}}


def test_with_devices_classify_matches_jax_with_mesh(tmp_path):
    """Two CPU replicas split an odd batch (5 -> 3 + 3, one pad row) and
    return the five rows; they equal the JAX engine over a 2-device data
    mesh and the port's single engine; the YUV and encode forms split
    alike."""
    import jax

    from vae_tagger_tpu.infer import TaggerEngine as JaxEngine
    from vae_tagger_tpu.parallel.mesh import make_mesh
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine

    art = _engine_artifacts(str(tmp_path))
    rng = np.random.default_rng(5)
    pixels = rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    jax_engine = JaxEngine.load(**art,
                                mesh=make_mesh(devices=jax.devices()[:2]))
    want = np.asarray(jax_engine.classify(pixels))
    single = TaggerEngine.load(device="cpu", **art)
    engine = single.with_devices(["cpu", "cpu"])
    assert len(engine.replicas) == 2 and single.replicas is None
    probs, n = engine.classify_async(pixels)
    assert n == 5 and probs.shape == (5, TAGS)
    np.testing.assert_allclose(probs.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(probs.numpy(), single.classify(pixels),
                               rtol=0, atol=1e-6)
    y = rng.integers(0, 256, (5, 64, 64), dtype=np.uint8)
    cbcr = rng.integers(0, 256, (5, 2, 32, 32), dtype=np.uint8)
    np.testing.assert_allclose(engine.classify_yuv(y, cbcr),
                               single.classify_yuv(y, cbcr), atol=1e-6)
    np.testing.assert_allclose(engine.encode(pixels), single.encode(pixels),
                               atol=1e-6)


# --------------------------------------------------------------------------
# two gloo ranks
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(target: str, workdir: Path, world: int = 2):
    """``target(workdir)`` of this module in ``world`` processes under a
    torchrun-style environment (gloo on the CPU); fails with their output
    if any rank fails."""
    port = _free_port()
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
            f"import torch; torch.set_num_threads(2); "
            f"import test_torch_parallel as t; t.{target}({str(workdir)!r})")
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out}"
    return outs


def _step_inputs(workdir: Path):
    """The JAX models' weights (perturbed), the global batch and every
    noise draw of one step, saved for the ranks; returns them."""
    import jax
    import jax.numpy as jnp

    from vae_tagger_tpu.core.config import AttentionDecoderConfig as JaxAttn
    from vae_tagger_tpu.core.config import default_flux_vae_config as jcfg
    from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL
    from vae_tagger_tpu.models.taggers import AttentionClassificationDecoder
    from vae_tagger_tpu_torch.io.checkpoints import (
        torch_state_from_jax_params,
    )

    vae = AutoencoderKL(jcfg(**TINY))
    vparams = _perturb(jax.jit(vae.init)(
        {"params": jax.random.key(0)}, jnp.zeros((1, RES, RES, 3)),
        jax.random.key(1))["params"], 4)
    head = AttentionClassificationDecoder(
        latent_channels=LATENT, num_classes=TAGS,
        attention=JaxAttn(attention_heads=2, attention_dropout=0.1))
    hparams = _perturb(jax.jit(head.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(2)}, jnp.zeros((1, 4, 4, LATENT)),
        deterministic=True)["params"], 5)
    stats = _stats(LATENT // 2)
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, 256, size=(B, RES, RES, 3), dtype=np.uint8)
             for k in ("anchor", "positive", "negative")}
    for k in ("labels", "positive_labels"):
        batch[k] = (rng.uniform(size=(B, TAGS)) < 0.4).astype(np.float32)
    latent = (RES // 8, RES // 8, LATENT)
    normal = {n: rng.normal(size=(n, *latent)).astype(np.float32)
              for n in (3 * B, B)}
    uniform = {s: rng.uniform(size=s).astype(np.float32)
               for s in DROPOUT_SHAPES}
    torch.save({"vae": torch_state_from_jax_params(vparams),
                "head": torch_state_from_jax_params(hparams, stats),
                "batch": batch, "normal": normal, "uniform": uniform},
               workdir / "inputs.pt")
    return vae, vparams, head, hparams, stats, batch, normal, uniform


def _port_step(workdir: str):
    """One full-loss ``FullSteps.train_step`` on this process's slice of
    the saved global batch (the whole batch without a process group),
    the draws patched to the saved global noise; returns and, on rank 0,
    saves (metrics, averaged gradients, BatchNorm running statistics)."""
    from vae_tagger_tpu_torch.models import autoencoder_kl, taggers

    mesh.initialize_distributed("cpu")
    inputs = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    normal, uniform = inputs["normal"], inputs["uniform"]
    draws = autoencoder_kl._randn, taggers._rand
    autoencoder_kl._randn = (lambda shape, generator, device:
                             torch.from_numpy(normal[shape[0]]))
    taggers._rand = (lambda shape, generator, device:
                     torch.from_numpy(uniform[tuple(shape)]))
    try:
        return _patched_port_step(workdir, inputs)
    finally:
        autoencoder_kl._randn, taggers._rand = draws


def _patched_port_step(workdir, inputs):
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from vae_tagger_tpu_torch.models.taggers import (
        AttentionClassificationDecoder,
    )
    from vae_tagger_tpu_torch.train.state import Optimizer, TrainState
    from vae_tagger_tpu_torch.train.steps import FullSteps

    vae = AutoencoderKL(default_flux_vae_config(**TINY), with_decoder=True)
    vae.load_state_dict(inputs["vae"], strict=True)
    head = AttentionClassificationDecoder(LATENT, TAGS, AttentionDecoderConfig(
        attention_heads=2, attention_dropout=0.1))
    head.load_state_dict(inputs["head"], strict=False)
    named = ([("vae." + n, p) for n, p in vae.named_parameters()]
             + [("head." + n, p) for n, p in head.named_parameters()])
    opt = Optimizer([p for _, p in named], lambda count: 1e-3,
                    max_grad_norm=0.0)
    grads = {}

    def record_then_step(step=opt.adamw.step):
        grads.update({n: p.grad.clone() for n, p in named
                      if p.grad is not None})
        step()

    opt.adamw.step = record_then_step
    state = TrainState(vae=vae.train(), decoder=head.train(), optimizer=opt)
    rows = slice(mesh.process_index() * B // mesh.process_count(),
                 (mesh.process_index() + 1) * B // mesh.process_count())
    batch = {k: v[rows] for k, v in inputs["batch"].items()}
    metrics = FullSteps(LossConfig(**CFG), use_simplified=False).train_step(
        state, batch, 0)
    out = ({k: v.item() for k, v in metrics.items() if v.dim() == 0},
           grads, {k: v.clone() for k, v in head.state_dict().items()
                   if k.startswith("feature_compress.1.running")})
    if mesh.is_main_process() and torch.distributed.is_initialized():
        torch.save(out, Path(workdir) / "rank0.pt")
    return out


def _assert_grads_close(got, want, rel):
    assert set(got) == set(want)
    for name, w in want.items():
        g = np.asarray(got[name])
        w = np.asarray(w)
        norm = float(np.linalg.norm(w))
        diff = float(np.linalg.norm(g - w))
        if norm < 1e-6:  # structurally zero (a key projection's bias)
            assert np.linalg.norm(g) < 1e-6, name
        else:
            assert diff / norm <= rel, (name, diff / norm)


def test_two_rank_step_matches_jax_mesh_and_one_process(tmp_path,
                                                         monkeypatch):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import optax

    from vae_tagger_tpu.losses import combined as jax_combined
    from vae_tagger_tpu.models import autoencoder_kl as jax_ak
    from vae_tagger_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from vae_tagger_tpu.train import steps as jax_steps
    from vae_tagger_tpu.train.state import TrainState as JaxTrainState
    from vae_tagger_tpu_torch.io.checkpoints import (
        torch_state_from_jax_params,
    )

    (vae, vparams, head, hparams, stats, batch, normal,
     uniform) = _step_inputs(tmp_path)
    _run_ranks("_port_step", tmp_path)
    dp_metrics, dp_grads, dp_stats = torch.load(tmp_path / "rank0.pt",
                                                weights_only=False)
    one_metrics, one_grads, one_stats = _port_step(str(tmp_path))
    assert set(dp_metrics) == set(one_metrics)
    for k, v in one_metrics.items():
        assert dp_metrics[k] == pytest.approx(v, rel=1e-5), k
    _assert_grads_close(dp_grads, one_grads, 1e-5)
    for k, v in one_stats.items():
        np.testing.assert_allclose(dp_stats[k], v, rtol=1e-5, err_msg=k)

    class TwoPassBatchNorm(fnn.BatchNorm):
        use_fast_variance: bool = False

    def dropout(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.merge_param("deterministic", self.deterministic,
                                        deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        keep = jnp.asarray(uniform[tuple(inputs.shape)]) >= self.rate
        return jnp.where(keep, inputs / (1.0 - self.rate), 0.0)

    monkeypatch.setattr(fnn, "BatchNorm", TwoPassBatchNorm)
    monkeypatch.setattr(fnn.Dropout, "__call__", dropout)
    monkeypatch.setattr(jax_ak.DiagonalGaussian, "sample",
                        lambda self, rng: self.mean + self.std * jnp.asarray(
                            normal[self.mean.shape[0]]))
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))
    train_step, _ = jax_steps.make_full_steps(
        vae, head, jax_combined.LossConfig(**CFG), use_simplified=False)
    data_mesh = make_mesh(devices=jax.devices()[:2])
    jstate = replicate(JaxTrainState.create(
        {"vae": vparams, "decoder": hparams}, keep_grads,
        batch_stats=jax.tree.map(jnp.asarray, stats)), data_mesh)
    jstate, jmetrics = train_step(jstate, shard_batch(batch, data_mesh),
                                  jax.random.key(0))
    for k, v in jmetrics.items():
        if np.ndim(v) == 0:
            assert dp_metrics[k] == pytest.approx(float(v), rel=1e-4), k
    jg = jax.device_get(jstate.opt_state)
    want = {"vae." + k: v for k, v in
            torch_state_from_jax_params(jg["vae"]).items()}
    want.update({"head." + k: v for k, v in
                 torch_state_from_jax_params(jg["decoder"]).items()})
    _assert_grads_close(dp_grads, want, 1e-4)
    jstats = jax.device_get(jstate.batch_stats)["feature_compress_1"]
    np.testing.assert_allclose(dp_stats["feature_compress.1.running_mean"],
                               jstats["mean"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dp_stats["feature_compress.1.running_var"],
                               jstats["var"], rtol=1e-4, atol=1e-6)


def _cli_data(root: Path) -> list:
    """A tiny VAE checkpoint, a head, 10 tagged 40px PNGs; the trainer's
    arguments without the batch size and output directory."""
    from PIL import Image

    from vae_tagger_tpu_torch.io.checkpoints import (
        save_decoder_bin,
        save_vae_pretrained,
    )
    from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from vae_tagger_tpu_torch.models.taggers import (
        AttentionClassificationDecoder,
    )
    from vae_tagger_tpu_torch.nn.blocks import seeded_init_

    cfg = default_flux_vae_config(**TINY)
    save_vae_pretrained(seeded_init_(AutoencoderKL(cfg, with_decoder=True),
                                     0), cfg, str(root / "vae"))
    save_decoder_bin(seeded_init_(AttentionClassificationDecoder(
        LATENT, TAGS, AttentionDecoderConfig(attention_heads=1)), 1),
        str(root / "head.bin"))
    rng = np.random.default_rng(8)
    tags = [f"t{i}" for i in range(TAGS)]
    (root / "tags.csv").write_text(
        "name,count\n" + "".join(f"{t},1\n" for t in tags))
    (root / "images").mkdir()
    data = {}
    for i in range(10):
        p = root / "images" / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
                        ).save(p)
        data[str(p)] = ", ".join(f"{t}:0.9" for t in
                                 rng.choice(tags, 2, replace=False))
    (root / "data.json").write_text(json.dumps(data))
    return ["--device", "cpu", "--json_path", str(root / "data.json"),
            "--tags_csv_path", str(root / "tags.csv"),
            "--vae_checkpoint",
            str(root / "vae" / "diffusion_pytorch_model.safetensors"),
            "--vae_config_path", str(root / "vae" / "config.json"),
            "--decoder_checkpoint", str(root / "head.bin"),
            "--resolution", str(RES), "--save_steps", "1",
            "--logging_steps", "1", "--num_workers", "1",
            "--mixed_precision", "no", "--attention_heads", "1",
            "--no_simplified_loss", "--num_epochs", "1"]


def _cli_rank(workdir: str):
    """One epoch of the train_full CLI at a local batch of 1, into an
    output directory of this rank's own (so a write by rank 1 shows)."""
    from vae_tagger_tpu_torch.train import train_full

    root = Path(workdir)
    argv = json.loads((root / "argv.json").read_text())
    train_full.main([*argv, "--train_batch_size", "1", "--output_dir",
                     str(root / f"rank{mesh.process_index()}")])


def test_two_rank_cli_epoch_writes_from_rank0_and_matches_one_process(
        tmp_path):
    from vae_tagger_tpu_torch.train import train_full

    argv = _cli_data(tmp_path)
    (tmp_path / "argv.json").write_text(json.dumps(argv))
    outs = _run_ranks("_cli_rank", tmp_path)
    assert "batch: 2 (global, 2 processes)" in outs[0]
    assert not (tmp_path / "rank1").exists()
    dp = tmp_path / "rank0"
    one = tmp_path / "one"
    train_full.main([*argv, "--train_batch_size", "2", "--output_dir",
                     str(one)])
    assert json.loads((dp / "optimal_thresholds.json").read_text()) == \
        json.loads((one / "optimal_thresholds.json").read_text())
    assert (dp / "evaluation_results.csv").read_text() == \
        (one / "evaluation_results.csv").read_text()
    got = json.loads((dp / "evaluation_results_overall.json").read_text())
    want = json.loads((one / "evaluation_results_overall.json").read_text())
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k
    h_dp = json.loads((dp / "training_history.json").read_text())
    h_one = json.loads((one / "training_history.json").read_text())
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(h_dp[k], h_one[k], rtol=1e-5)
    saved = torch.load(dp / "checkpoint-0" / "train_state.pt",
                       weights_only=True)
    assert saved["step"] == 5
    resumed = tmp_path / "resumed"
    train_full.main([*argv, "--train_batch_size", "2", "--output_dir",
                     str(resumed), "--resume_from",
                     str(dp / "checkpoint-0")])
    again = torch.load(resumed / "checkpoint-0" / "train_state.pt",
                       weights_only=True)
    assert again["step"] == 10 and again["optimizer"]["count"] == 10
