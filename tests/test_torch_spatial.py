"""The port's height-sharded spatial parallelism on the CPU
(``vae_tagger_tpu_torch/parallel/spatial.py`` and the slab forms of the
blocks, the VAE, the engine and the steps), against the unsharded port
and the JAX package's spatial forms on the virtual CPU devices that
conftest.py pins:

- the primitives at 2 and 4 slabs against the unsharded tensors: the halo
  exchange (nothing at the true image edge), the global GroupNorm
  statistics (a slab's own rows only; forward and gradient) and the
  attention of local queries against the gathered keys and values
  (forward, and dK/dV summed over the slabs), then every block's slab form;
- spatial encode and classify against JAX's ``with_spatial_mesh`` on the
  8-device ``("model",)`` mesh and on a 2-device one, and against the
  port's unsharded engine (latents MSE < 1e-10, probabilities atol 1e-5);
  the 2 x 4 grid with an odd batch padded on the data axis; no padding in
  pure spatial mode; the refusals;
- one ``train_full`` step (simplified loss, the head in train mode) and
  one ``train_vae`` step against the JAX package's spatial steps over the
  8-device mesh (loss rtol 1e-5; every gradient within 1e-4 of JAX's,
  relative to its norm, and the SGD update within rtol 1e-4, atol 1e-6),
  and against the port's unsharded steps (loss rel 1e-5, gradients 1e-4);
- the entry points with ``parallel.mesh.local_devices`` patched to two
  names of the CPU, so that each command line shards every image over two
  slabs in one process: the three trainers (``train_full``,
  ``train_vae``, ``train_decoder --cache_latents``) for one epoch (the
  training loss equal to the run without the flag, rel 1e-4; the
  validation loss and the final phase's threshold close, see the test;
  the encoder, and ``train_vae``'s decoder, ran on slabs), the infer CLI
  (its JSON equal to the run without the flag, 1e-5; ``--transfer_format
  yuv420`` ignored for RGB) and an HTTP request to the server that
  ``python -m vae_tagger_tpu_torch.serve`` builds (the unsharded
  engine's probabilities for the request's pixels), with tiny models at
  32px, whose latent grid of 4 rows splits over 2 slabs.

Randomness cannot match across frameworks, so numpy gives both sides the
posterior noise (told apart by its batch size) and the dropout draws (by
shape), and flax's BatchNorm takes its two-pass variance, as the port
does (tests/test_torch_parallel.py).  The config is
``tests/test_spatial_parallel.py``'s: 16 latent channels (with 4, the
head's train-mode BatchNorm amplifies fp32 rounding about 250-fold), 64px
so that 8 slabs keep whole latent rows.
"""

import importlib
import io
import json
import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from vae_tagger_tpu.core.config import default_flux_vae_config as jax_cfg
from vae_tagger_tpu.infer import TaggerEngine as JaxEngine
from vae_tagger_tpu.infer.engine import build_decoder as jax_build_decoder
from vae_tagger_tpu.losses.combined import LossConfig as JaxLossConfig
from vae_tagger_tpu.models import autoencoder_kl as jax_ak
from vae_tagger_tpu.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch_spatial,
)
from vae_tagger_tpu.train import steps as jax_steps
from vae_tagger_tpu.train.state import TrainState as JaxTrainState
from vae_tagger_tpu_torch.core.cli import refuse_unported
from vae_tagger_tpu_torch.core.config import (
    AttentionDecoderConfig,
    default_flux_vae_config,
)
from vae_tagger_tpu_torch.data.bucketing import decode_bytes_square
from vae_tagger_tpu_torch.infer.engine import TaggerEngine, build_decoder
from vae_tagger_tpu_torch.io.checkpoints import (
    save_decoder_bin,
    save_vae_pretrained,
    torch_state_from_jax_params,
)
from vae_tagger_tpu_torch.losses.combined import LossConfig
from vae_tagger_tpu_torch.models import autoencoder_kl, taggers
from vae_tagger_tpu_torch.models.autoencoder_kl import (
    AutoencoderKL,
    Decoder,
    Encoder,
)
from vae_tagger_tpu_torch.models.taggers import AttentionClassificationDecoder
from vae_tagger_tpu_torch.nn import blocks
from vae_tagger_tpu_torch.ops import backend
from vae_tagger_tpu_torch.ops.attention import (
    flash_attention,
    spatial_single_head_attention_sharded,
)
from vae_tagger_tpu_torch.ops.normalization import group_stats_plain
from vae_tagger_tpu_torch.parallel import mesh, spatial
from vae_tagger_tpu_torch.parallel.spatial import SpatialMesh
from vae_tagger_tpu_torch.train import steps as port_steps
from vae_tagger_tpu_torch.train.loop import build_dataset_and_loaders
from vae_tagger_tpu_torch.train.state import TrainState

CFG = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
           latent_channels=16, sample_size=64)
RES, TAGS, B = 64, 5, 2
CPU = torch.device("cpu")
# gradients that are zero in exact arithmetic, so both sides hold only
# fp32 rounding noise there: the key projections' biases (softmax ignores
# a shift shared by all keys) and the conv bias before the head's
# train-mode BatchNorm (which removes it); compared against NOISE_NORM,
# absolutely
STRUCTURALLY_ZERO = ("to_k.bias", "k_proj.bias",
                     "head.feature_compress.0.bias")
NOISE_NORM = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two threads in this process: the suite's workers share the host's
    cores, and torch's default of a thread a core makes them contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _cpu_only():
    backend.reset_launch_counts()
    yield
    assert sum(backend.launch_counts().values()) == 0


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a, np.float32)
        + (rng.normal(size=np.shape(a)) * scale).astype(np.float32)
        for a in leaves])


def _uniform(shape):
    """The dropout draw of one shape, the same on both sides."""
    seed = int(np.prod(shape)) * 31 + len(shape)
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """JAX weights (perturbed off their init) and the port's copies."""
    vae = jax_ak.AutoencoderKL(jax_cfg(**CFG))
    vparams = _perturb(jax.jit(vae.init)(
        {"params": jax.random.key(0)}, jnp.zeros((1, RES, RES, 3)),
        jax.random.key(1))["params"], 4)
    head = jax_build_decoder(TAGS, use_attention=True, latent_channels=16)
    hvars = jax.jit(head.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(2)}, jnp.zeros((1, 8, 8, 16)),
        deterministic=True)
    hparams = _perturb(hvars["params"], 5)
    rng = np.random.default_rng(3)
    stats = {"feature_compress_1": {
        "mean": (rng.normal(size=(8,)) * 0.1).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, size=(8,)).astype(np.float32)}}

    def port(with_decoder=False):
        pv = AutoencoderKL(default_flux_vae_config(**CFG),
                           with_decoder=with_decoder)
        pv.load_state_dict(torch_state_from_jax_params(vparams),
                           strict=with_decoder)
        ph = build_decoder(TAGS, latent_channels=16)
        ph.load_state_dict(torch_state_from_jax_params(hparams, stats),
                           strict=False)
        return pv, ph

    return dict(vae=vae, vparams=vparams, head=head, hparams=hparams,
                stats=stats, port=port)


@pytest.fixture(scope="module")
def engines(models):
    tags = [f"t{i}" for i in range(TAGS)]
    jax_engine = JaxEngine(
        vae=models["vae"], vae_params=models["vparams"],
        decoder=models["head"],
        decoder_variables={"params": models["hparams"],
                           "batch_stats": models["stats"]},
        tag_names=tags)
    vae, head = models["port"]()
    return jax_engine, TaggerEngine(vae, head, tags, device="cpu")


# --------------------------------------------------------------------------
# the primitives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_halo_exchange(n):
    """Neighbours' rows at a slab boundary, nothing at the image edge; the
    crop and the gather give the slabs and the image back."""
    x = torch.arange(2 * 16 * 3 * 2, dtype=torch.float32).reshape(2, 16, 3, 2)
    xs = spatial.shard_height(x, [CPU] * n)
    h = 16 // n
    for above, below in ((1, 1), (0, 1), (2, 1)):
        exts, tops = spatial.halo(xs, above, below)
        for i, (e, t) in enumerate(zip(exts, tops)):
            lo = max(0, i * h - above)
            hi = min(16, (i + 1) * h + below)
            assert t == i * h - lo
            assert torch.equal(e, x[:, lo:hi])
        assert all(torch.equal(a, b) for a, b in
                   zip(spatial.crop(exts, tops, h), xs))
    assert torch.equal(spatial.gather_height(xs, CPU), x)


@pytest.mark.parametrize("n", [2, 4])
def test_global_group_stats_cover_own_rows(n):
    """The combined statistics are the whole image's (not the halo's), and
    their gradient is the unsharded one."""
    g = torch.Generator().manual_seed(n)
    x = torch.randn(2, 16, 4, 8, generator=g) * 2 + 1
    a, b = torch.randn(2, 4, generator=g), torch.randn(2, 4, generator=g)
    xr = x.clone().requires_grad_(True)
    mean, meansq = group_stats_plain(xr, 4)
    ((mean * a).sum() + (meansq * b).sum()).backward()
    xs = [s.detach().requires_grad_(True)
          for s in spatial.shard_height(x, [CPU] * n)]
    stats = spatial.global_group_stats(xs, 4)
    for m, q in stats:
        torch.testing.assert_close(m, mean.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(q, meansq.detach(), rtol=1e-6, atol=1e-6)
    m, q = stats[0]
    ((m * a).sum() + (q * b).sum()).backward()
    torch.testing.assert_close(torch.cat([s.grad for s in xs], dim=1),
                               xr.grad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", [2, 4])
def test_gathered_attention_and_its_gradients(n):
    """Local query rows against the gathered keys and values: the output
    and the gradients of q, k and v (dK and dV summed over the slabs)."""
    g = torch.Generator().manual_seed(10 + n)
    q, k, v = (torch.randn(2, 32, 16, generator=g) for _ in range(3))
    do = torch.randn(2, 32, 16, generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention(*leaves)
    (ref * do).sum().backward()
    parts = [[s.detach().requires_grad_(True) for s in t.chunk(n, dim=1)]
             for t in (q, k, v)]
    outs = spatial_single_head_attention_sharded(*parts)
    torch.testing.assert_close(torch.cat(outs, dim=1), ref.detach(),
                               rtol=1e-5, atol=1e-6)
    sum((o * d).sum() for o, d in zip(outs, do.chunk(n, dim=1))).backward()
    for slabs, leaf in zip(parts, leaves):
        torch.testing.assert_close(torch.cat([s.grad for s in slabs], dim=1),
                                   leaf.grad, rtol=1e-5, atol=1e-6)


def _blocks():
    torch.manual_seed(0)
    mods = {
        "conv3x3": blocks.Conv2D(8, 8),
        "conv1x1": blocks.Conv2D(8, 4, 1, padding=0),
        "group_norm_silu": blocks.GroupNorm(4, 8, with_silu=True),
        "resnet_shortcut": blocks.ResnetBlock(8, 16, num_groups=4),
        "downsample": blocks.Downsample(8),
        "upsample": blocks.Upsample(8),
        "attention": blocks.VAEAttention(8, num_groups=4),
    }
    for m in mods.values():
        blocks.seeded_init_(m, 1)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.1 * torch.randn_like(p))
    return mods


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["conv3x3", "conv1x1", "group_norm_silu",
                                  "resnet_shortcut", "downsample",
                                  "upsample", "attention"])
def test_block_slab_forms_match_unsharded(name, n):
    """Each block's ``forward_slabs`` against its ``forward``: the output
    and the gradients of the input and of every parameter."""
    mod = _blocks()[name]
    x = torch.randn(2, 16, 6, 8, generator=torch.Generator().manual_seed(7))
    xr = x.clone().requires_grad_(True)
    ref = mod(xr)
    do = torch.randn(ref.shape, generator=torch.Generator().manual_seed(8))
    (ref * do).sum().backward()
    want = {k: p.grad.clone() for k, p in mod.named_parameters()}
    mod.zero_grad()
    xs = [s.detach().requires_grad_(True)
          for s in spatial.shard_height(x, [CPU] * n)]
    outs = mod.forward_slabs(xs)
    torch.testing.assert_close(torch.cat(outs, dim=1), ref.detach(),
                               rtol=1e-5, atol=1e-5)
    sum((o * d).sum() for o, d in zip(outs, do.chunk(n, dim=1))).backward()
    torch.testing.assert_close(torch.cat([s.grad for s in xs], dim=1),
                               xr.grad, rtol=1e-4, atol=1e-5)
    for k, p in mod.named_parameters():
        if k.endswith(STRUCTURALLY_ZERO):
            assert max(p.grad.norm(), want[k].norm()) < NOISE_NORM, k
        else:
            assert ((p.grad - want[k]).norm() / want[k].norm()) < 1e-5, k


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def _mse(a, b):
    return float(np.mean((np.asarray(a, np.float64) - b) ** 2))


@pytest.mark.parametrize("n", [8, 2])
def test_spatial_encode_and_classify_match_jax(engines, n):
    """``with_spatial`` over n CPU slabs against the JAX engine's
    ``with_spatial_mesh`` over n devices and the port's unsharded engine."""
    jax_engine, engine = engines
    jax_sp = jax_engine.with_spatial_mesh(
        make_mesh(("model",), devices=jax.devices()[:n]))
    sp = engine.with_spatial([CPU] * n)
    assert sp.spatial.shards == n and engine.spatial is None
    px = np.random.default_rng(n).integers(0, 256, (3, RES, RES, 3),
                                           dtype=np.uint8)
    latents = sp.encode(px)
    assert latents.shape == (3, 8, 8, 16)
    assert _mse(latents, np.asarray(jax_sp.encode(px))) < 1e-10
    assert _mse(latents, engine.encode(px)) < 1e-10
    probs = sp.classify(px)
    assert probs.shape == (3, TAGS)
    np.testing.assert_allclose(probs, np.asarray(jax_sp.classify(px)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(probs, engine.classify(px), rtol=0, atol=1e-5)


def test_grid_pads_an_odd_batch_on_the_data_axis(engines):
    """The 2 x 4 grid: an odd batch padded to the 2 data rows, the pad row
    dropped; equal to the JAX grid and to the unsharded engine."""
    jax_engine, engine = engines
    jax_grid = jax_engine.with_spatial_mesh(
        make_mesh(("data", "model"), shape=(2, 4)))
    grid = engine.with_spatial([CPU] * 8, data_ways=2)
    assert grid.spatial.shards == 4 and grid.spatial.data_ways == 2
    px = np.random.default_rng(9).integers(0, 256, (3, RES, RES, 3),
                                           dtype=np.uint8)
    rows = []
    encode = grid.vae.encode
    grid.vae.encode = lambda x, spatial=None: (rows.append(
        (x.shape[0], spatial.shards)), encode(x, spatial))[1]
    try:
        probs = grid.classify(px)
    finally:
        del grid.vae.encode
    assert rows == [(2, 4), (2, 4)]  # 3 rows padded to 4, 2 a data row
    assert probs.shape == (3, TAGS)
    np.testing.assert_allclose(probs, np.asarray(jax_grid.classify(px)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(probs, engine.classify(px), rtol=0, atol=1e-5)


def test_pure_spatial_mode_does_not_pad_the_batch(engines):
    _, engine = engines
    sp = engine.with_spatial([CPU] * 8)
    seen = []
    encode = sp.vae.encode
    sp.vae.encode = lambda x, spatial=None: (seen.append(x.shape[0]),
                                             encode(x, spatial))[1]
    try:
        px = np.zeros((1, RES, RES, 3), np.uint8)
        assert sp.classify(px).shape == (1, TAGS)
    finally:
        del sp.vae.encode
    assert seen == [1]


def test_refuses_an_indivisible_height_and_yuv(engines):
    """32px over 8 slabs leaves no whole latent row: refused with the JAX
    message; the YUV methods are refused as in the JAX package."""
    _, engine = engines
    sp = engine.with_spatial([CPU] * 8)
    with pytest.raises(ValueError, match="divisible"):
        sp.classify(np.zeros((1, 32, 32, 3), np.uint8))
    y = np.zeros((1, RES, RES), np.uint8)
    cbcr = np.zeros((1, 2, RES // 2, RES // 2), np.uint8)
    for method in (sp.classify_yuv, sp.encode_yuv):
        with pytest.raises(NotImplementedError, match="YUV transfer"):
            method(y, cbcr)
    with pytest.raises(ValueError, match="rows"):
        SpatialMesh([CPU] * 3, data_ways=2)


def test_trainer_refusals_and_the_one_device_no_op(monkeypatch, tmp_path):
    """More than one process: refused with the JAX message.  yuv420 with
    spatial: refused by the loader.  Resolutions that do not split:
    refused ("divisible").  One local device: no mesh (a no-op)."""
    import argparse

    args = argparse.Namespace(spatial_parallel=True, device="cpu",
                              resolution=RES, use_bucketing=False,
                              transfer_format="yuv420")
    with pytest.raises(SystemExit, match="single-controller"):
        refuse_unported(args, 2)
    refuse_unported(args, 1)
    assert spatial.trainer_mesh(args, 8) is None  # --device cpu: one device
    monkeypatch.setattr(mesh, "local_devices", lambda device: [CPU] * 8)
    with pytest.raises(ValueError, match="yuv420 is not supported"):
        build_dataset_and_loaders(args)
    assert spatial.trainer_mesh(args, 8).shards == 8
    args.resolution = 48
    with pytest.raises(ValueError, match="divisible by 64"):
        spatial.trainer_mesh(args, 8)
    args.use_bucketing, args.base_resolution, args.bucket_step = True, 128, 32
    with pytest.raises(ValueError, match=r"got \[32\]"):
        spatial.trainer_mesh(args, 8)
    args.spatial_parallel = False
    assert spatial.trainer_mesh(args, 8) is None


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, 256, size=(B, RES, RES, 3), dtype=np.uint8)
             for k in ("anchor", "positive", "negative")}
    for k in ("labels", "positive_labels"):
        batch[k] = (rng.uniform(size=(B, TAGS)) < 0.4).astype(np.float32)
    noise = {n: rng.normal(size=(n, 8, 8, 16)).astype(np.float32)
             for n in (3 * B, B)}
    return batch, noise


def _patch_draws(monkeypatch, noise):
    """numpy noise on both sides: the posterior's by batch size, dropout's
    by shape; flax's BatchNorm on its two-pass variance."""

    class TwoPassBatchNorm(fnn.BatchNorm):
        use_fast_variance: bool = False

    def dropout(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.merge_param("deterministic", self.deterministic,
                                        deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        keep = jnp.asarray(_uniform(tuple(inputs.shape))) >= self.rate
        return jnp.where(keep, inputs / (1.0 - self.rate), 0.0)

    monkeypatch.setattr(fnn, "BatchNorm", TwoPassBatchNorm)
    monkeypatch.setattr(fnn.Dropout, "__call__", dropout)
    monkeypatch.setattr(jax_ak.DiagonalGaussian, "sample",
                        lambda self, rng: self.mean + self.std * jnp.asarray(
                            noise[self.mean.shape[0]]))
    monkeypatch.setattr(autoencoder_kl, "_randn",
                        lambda shape, generator, device:
                        torch.from_numpy(noise[shape[0]]))
    monkeypatch.setattr(taggers, "_rand", lambda shape, generator, device:
                        torch.from_numpy(_uniform(tuple(shape))))


def _keep_grads():
    """An optax transformation whose state is the last gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _jax_spatial_step(make_step, params, batch, batch_stats=None):
    """One step of a JAX step factory over the 8-device ``("model",)`` mesh
    with the batch's height sharded; returns (metrics, gradients)."""
    mesh8 = make_mesh(("model",))
    step, _ = make_step(force_xla_kernels=True, spatial_mesh=mesh8)
    state = replicate(JaxTrainState.create(
        jax.tree.map(jnp.array, params), _keep_grads(),
        batch_stats=batch_stats), mesh8)
    state, metrics = step(state, shard_batch_spatial(batch, mesh8),
                          jax.random.key(7))
    return metrics, jax.device_get(state.opt_state)


def _port_step(steps, vae, head, batch):
    """(metrics, gradients) of one port step on the CPU."""
    state = TrainState(vae=vae.train(), decoder=head, optimizer=None)
    total, metrics, _ = steps.forward_losses(
        state, port_steps.batch_to_device(batch, CPU), None, train=True)
    total.backward()
    named = [("vae." + n, p) for n, p in vae.named_parameters()]
    if head is not None:
        named += [("head." + n, p) for n, p in head.named_parameters()]
    return ({k: v.item() for k, v in metrics.items()},
            {n: p.grad for n, p in named if p.grad is not None})


def _assert_grads_match(got, want, rel=1e-4):
    """Every gradient within ``rel`` of want's, relative to its norm; a
    tensor the port gives no gradient (the VAE decoder under the
    simplified loss) has a zero one in want."""
    assert set(got) <= set(want)
    for name in set(want) - set(got):
        assert not np.any(want[name]), name
    for name, w in ((k, want[k]) for k in got):
        g = got[name].numpy()
        w = np.asarray(w)
        norm = float(np.linalg.norm(w))
        if name.endswith(STRUCTURALLY_ZERO):
            assert max(norm, np.linalg.norm(g)) < NOISE_NORM, name
        else:
            assert np.linalg.norm(g - w) / norm <= rel, name


def _assert_sgd_update_matches(models_params, got, want, prefix):
    """The SGD(1e-2) update of the JAX spatial test, from each side's
    gradients: rtol 1e-4, atol 1e-6."""
    start = torch_state_from_jax_params(models_params)
    for k, p in start.items():
        name = prefix + k
        if name not in got:
            continue
        np.testing.assert_allclose((p - 1e-2 * got[name]).numpy(),
                                   p.numpy() - 1e-2 * np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def _named_jax_grads(jgrads, parts):
    out = {}
    for prefix, tree in parts:
        out.update({prefix + k: v.numpy() for k, v in
                    torch_state_from_jax_params(jgrads[tree]).items()})
    return out


def test_train_full_step_matches_jax_spatial_and_unsharded(models,
                                                           monkeypatch):
    """One simplified-loss ``FullSteps`` step with the head in train mode
    (BatchNorm on batch statistics, dropout), the stacked triplet encode
    sharded over 8 CPU slabs: loss and every gradient against JAX's
    spatial ``make_full_steps`` step and the port's unsharded step."""
    batch, noise = _batch()
    _patch_draws(monkeypatch, noise)
    cfg = dict(use_focal_loss=True)

    def make_step(**kw):
        return jax_steps.make_full_steps(
            models["vae"], models["head"], JaxLossConfig(**cfg),
            use_simplified=True, **kw)

    jmetrics, jgrads = _jax_spatial_step(
        make_step, {"vae": models["vparams"], "decoder": models["hparams"]},
        batch, jax.tree.map(jnp.asarray, models["stats"]))
    want = _named_jax_grads(jgrads, (("vae.", "vae"), ("head.", "decoder")))
    runs = {}
    for name, sp in (("spatial", SpatialMesh([CPU] * 8)), ("plain", None)):
        vae, head = models["port"]()
        runs[name] = _port_step(port_steps.FullSteps(
            LossConfig(**cfg), spatial=sp), vae, head.train(), batch)
    (metrics, grads), (plain_metrics, plain_grads) = (runs["spatial"],
                                                      runs["plain"])
    for k, v in jmetrics.items():
        if np.ndim(v) == 0:
            assert metrics[k] == pytest.approx(float(v), rel=1e-5), k
            assert metrics[k] == pytest.approx(plain_metrics[k], rel=1e-5), k
    _assert_grads_match(grads, want)
    _assert_grads_match(grads, {k: v.numpy() for k, v in
                                plain_grads.items()})
    _assert_sgd_update_matches(models["vparams"], grads, want, "vae.")


def test_train_vae_step_matches_jax_spatial_and_unsharded(models,
                                                          monkeypatch):
    """One ``VaeSteps`` step with the KL optimized: the triplet encode and
    the anchor's decode sharded over 8 CPU slabs; loss, every metric and
    every encoder and decoder gradient against JAX's spatial
    ``make_vae_steps`` step and the port's unsharded step."""
    batch, noise = _batch()
    _patch_draws(monkeypatch, noise)
    cfg = dict(reconstruction_weight=0.5, kl_weight=0.3, triplet_weight=1.0)

    def make_step(**kw):
        return jax_steps.make_vae_steps(models["vae"], JaxLossConfig(**cfg),
                                        use_simplified=False, **kw)

    jmetrics, jgrads = _jax_spatial_step(make_step, models["vparams"], batch)
    want = {"vae." + k: v.numpy() for k, v in
            torch_state_from_jax_params(jgrads).items()}
    runs = {}
    for name, sp in (("spatial", SpatialMesh([CPU] * 8)), ("plain", None)):
        vae, _ = models["port"](with_decoder=True)
        runs[name] = _port_step(port_steps.VaeSteps(
            LossConfig(**cfg), use_simplified=False, spatial=sp), vae, None,
            batch)
    (metrics, grads), (plain_metrics, plain_grads) = (runs["spatial"],
                                                      runs["plain"])
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert metrics[k] == pytest.approx(float(v), rel=1e-5), k
        assert metrics[k] == pytest.approx(plain_metrics[k], rel=1e-5), k
    _assert_grads_match(grads, want)
    _assert_grads_match(grads, {k: v.numpy() for k, v in
                                plain_grads.items()})
    _assert_sgd_update_matches(models["vparams"], grads, want, "vae.")


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

CLI_RES, CLI_TAGS = 32, 6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny VAE (encoder and decoder), a head, 6 tagged 40px PNGs."""
    root = tmp_path_factory.mktemp("spatial_cli")
    cfg = default_flux_vae_config(block_out_channels=(8, 16, 16, 16),
                                  norm_num_groups=4, latent_channels=16)
    vae = blocks.seeded_init_(AutoencoderKL(cfg, with_decoder=True), 0)
    with torch.no_grad():  # off the identity norms and zero biases
        g = torch.Generator().manual_seed(1)
        for p in vae.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    save_vae_pretrained(vae, cfg, str(root / "vae"))
    head = blocks.seeded_init_(AttentionClassificationDecoder(
        16, CLI_TAGS, AttentionDecoderConfig()), 1)
    save_decoder_bin(head, str(root / "head.bin"))
    rng = np.random.default_rng(8)
    tags = [f"t{i}" for i in range(CLI_TAGS)]
    (root / "tags.csv").write_text(
        "name,count\n" + "".join(f"{t},1\n" for t in tags))
    (root / "images").mkdir()
    data = {}
    for i in range(6):
        p = root / "images" / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
                        ).save(p)
        data[str(p)] = ", ".join(f"{t}:0.9" for t in
                                 rng.choice(tags, 2, replace=False))
    (root / "data.json").write_text(json.dumps(data))
    vae_args = ["--vae_checkpoint",
                str(root / "vae" / "diffusion_pytorch_model.safetensors"),
                "--vae_config_path", str(root / "vae" / "config.json")]
    train = ["--device", "cpu", "--json_path", str(root / "data.json"),
             "--tags_csv_path", str(root / "tags.csv"), *vae_args,
             "--resolution", str(CLI_RES), "--train_batch_size", "2",
             "--num_epochs", "1", "--save_steps", "1",
             "--lr_warmup_steps", "1", "--mixed_precision", "no",
             "--num_workers", "1", "--seed", "3"]
    return dict(root=root, vae_args=vae_args, train=train,
                head=str(root / "head.bin"), tags=str(root / "tags.csv"))


def _patch_two_slabs(m):
    """``local_devices`` gives two names of the CPU; the slab forms of the
    encoder and decoder count their calls (returned)."""
    m.setattr(mesh, "local_devices", lambda device="cuda": [CPU, CPU])
    calls = {"encoder": 0, "decoder": 0}
    for name, cls in (("encoder", Encoder), ("decoder", Decoder)):
        def counted(self, xs, _name=name, _orig=cls.forward_slabs):
            calls[_name] += 1
            return _orig(self, xs)

        m.setattr(cls, "forward_slabs", counted)
    return calls


@pytest.fixture
def two_slabs(monkeypatch):
    return _patch_two_slabs(monkeypatch)


TRAINERS = {
    "train_full": ["--decoder_checkpoint", "HEAD"],
    "train_vae": [],
    "train_decoder": ["--decoder_checkpoint", "HEAD", "--cache_latents"],
}


@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_trainer_cli_over_two_slabs_matches_the_unsharded_run(
        run, trainer, tmp_path, monkeypatch, capsys):
    main = importlib.import_module(
        f"vae_tagger_tpu_torch.train.{trainer}").main
    extra = [run["head"] if a == "HEAD" else a for a in TRAINERS[trainer]]
    main([*run["train"], *extra, "--output_dir", str(tmp_path / "plain")])
    with monkeypatch.context() as m:
        calls = _patch_two_slabs(m)
        main([*run["train"], *extra, "--output_dir",
              str(tmp_path / "spatial"), "--spatial_parallel"])
    assert "spatial-parallel training over 2 devices" in capsys.readouterr(
        ).out
    assert calls["encoder"] > 0
    assert (calls["decoder"] > 0) == (trainer == "train_vae")
    hist = [json.loads((tmp_path / d / "training_history.json").read_text())
            for d in ("plain", "spatial")]
    np.testing.assert_allclose(hist[1]["train_loss"], hist[0]["train_loss"],
                               rtol=1e-4)
    # the validation loss reads the head's BatchNorm in eval mode, after
    # its input conv's bias: that bias's gradient is zero in exact
    # arithmetic, so AdamW turns either run's rounding noise into steps
    # of +-lr there (the JAX package's spatial step test takes SGD for
    # that reason); the steps themselves are held to 1e-4 in
    # tests/test_torch_spatial.py
    np.testing.assert_allclose(hist[1]["val_loss"], hist[0]["val_loss"],
                               rtol=0.05)
    if trainer != "train_vae":
        got, want = (json.loads((tmp_path / d / "optimal_thresholds.json"
                                 ).read_text()) for d in ("spatial", "plain"))
        assert got["global_threshold"] == pytest.approx(
            want["global_threshold"], abs=0.05)


def _infer(run, out, *flags):
    from vae_tagger_tpu_torch.infer.__main__ import main

    main(["--device", "cpu", *run["vae_args"], "--decoder_checkpoint",
          run["head"], "--image_path",
          str(run["root"] / "images"), "--tags_csv_path", run["tags"],
          "--output_dir", str(out), "--resolution", str(CLI_RES),
          "--batch_size", "3", "--confidence_threshold", "0", *flags])
    return json.loads((out / "classification_results.json").read_text())


def test_infer_cli_over_two_slabs(run, tmp_path, two_slabs, capsys):
    """The JSON equals the unsharded run's; yuv420 is ignored for RGB."""
    sp = _infer(run, tmp_path / "sp", "--spatial_parallel",
                "--transfer_format", "yuv420")
    out = capsys.readouterr().out
    assert "spatial-parallel inference over 2 devices" in out
    assert "--transfer_format yuv420 ignored" in out
    assert two_slabs["encoder"] == 2  # 6 images in batches of 3
    plain = _infer(run, tmp_path / "plain", "--no_data_parallel")
    assert set(sp) == set(plain) and len(sp) == 6
    for k in plain:
        a = {t["tag"]: t["confidence"] for t in sp[k]["predicted_tags"]}
        b = {t["tag"]: t["confidence"] for t in plain[k]["predicted_tags"]}
        assert a.keys() == b.keys()
        assert max(abs(a[t] - b[t]) for t in a) <= 1e-5


def test_server_over_two_slabs_answers_http(run, two_slabs):
    """``build_server`` with --spatial_parallel: the engine shards, max_batch
    stays 8, and a JPEG posted to /classify gets the unsharded engine's
    probabilities for its pixels."""
    from vae_tagger_tpu_torch.serve.__main__ import build_parser, build_server

    args = build_parser().parse_args([
        "--device", "cpu", *run["vae_args"], "--decoder_checkpoint",
        run["head"], "--tags_csv_path", run["tags"], "--resolution",
        str(CLI_RES), "--port", "0", "--confidence_threshold", "0",
        "--spatial_parallel", "--no_warmup"])
    server = build_server(args)
    engine = server.worker.engine
    assert engine.spatial is not None and engine.spatial.shards == 2
    assert server.worker.max_batch == 8
    rng = np.random.default_rng(4)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)).save(
        buf, "JPEG", quality=95)
    with server:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/classify", data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.load(r)
    assert two_slabs["encoder"] == 1
    single = TaggerEngine.load(
        vae_checkpoint=run["vae_args"][1], vae_config_path=run["vae_args"][3],
        decoder_checkpoint=run["head"], tags_csv_path=run["tags"],
        device="cpu")
    want = single.classify(decode_bytes_square(buf.getvalue(), CLI_RES)[None])[0]
    conf = {t["tag"]: t["confidence"] for t in got["predicted_tags"]}
    for j, name in enumerate(single.tag_names):
        assert abs(conf[name] - float(want[j])) <= 1e-4, name
