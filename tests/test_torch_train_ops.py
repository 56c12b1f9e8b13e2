"""The port's training pieces against the JAX package, on the CPU in fp32:
the attention backward (kernels D and E's plain versions and the autograd
Function) against the Pallas backward in interpret mode, the VJPs of the
GroupNorm and fused-conv ops, the losses, the LR schedules, clip + AdamW
with accumulation against optax, triplet mining and the split, and the
head's BatchNorm running statistics.  Inputs come from numpy with a seed.

Tolerances: fp32 atol 1e-5 unless a test states another, with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vae_tagger_tpu.core.config import AttentionDecoderConfig as JaxAttnCfg
from vae_tagger_tpu.data.dataset import TaggedImageDataset as JaxDataset
from vae_tagger_tpu.data.dataset import parse_weighted_tags as jax_parse
from vae_tagger_tpu.data.loader import BucketBatchSampler as JaxSampler
from vae_tagger_tpu.data.loader import train_val_split as jax_split
from vae_tagger_tpu.losses import classification as jcls
from vae_tagger_tpu.losses import combined as jcomb
from vae_tagger_tpu.losses import metric_learning as jml
from vae_tagger_tpu.models.taggers import (
    AttentionClassificationDecoder as JaxAttnHead,
)
from vae_tagger_tpu.ops.conv import gn_silu_conv3x3 as jax_gn_silu_conv3x3
from vae_tagger_tpu.ops.normalization import (
    group_norm_silu as jax_group_norm_silu,
)
from vae_tagger_tpu.ops.pallas.flash_attention import (
    _flash_attention_bwd_impl,
    _flash_attention_fwd_impl,
)
from vae_tagger_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from vae_tagger_tpu.train.schedule import build_lr_schedule as jax_schedule
from vae_tagger_tpu.train.state import build_optimizer as jax_optimizer
from vae_tagger_tpu_torch.core.config import AttentionDecoderConfig
from vae_tagger_tpu_torch.data.dataset import (
    TaggedImageDataset,
    parse_weighted_tags,
)
from vae_tagger_tpu_torch.data.loader import BucketBatchSampler, train_val_split
from vae_tagger_tpu_torch.io.checkpoints import torch_state_from_jax_params
from vae_tagger_tpu_torch.losses import classification as cls
from vae_tagger_tpu_torch.losses import combined as comb
from vae_tagger_tpu_torch.losses import metric_learning as ml
from vae_tagger_tpu_torch.models.taggers import AttentionClassificationDecoder
from vae_tagger_tpu_torch.ops import backend
from vae_tagger_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_bwd_plain,
)
from vae_tagger_tpu_torch.ops.conv import gn_silu_conv3x3
from vae_tagger_tpu_torch.ops.normalization import group_norm_silu
from vae_tagger_tpu_torch.train.schedule import build_lr_schedule
from vae_tagger_tpu_torch.train.state import build_optimizer

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_only():
    backend.reset_launch_counts()
    yield
    assert sum(backend.launch_counts().values()) == 0


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _close(got, want, rtol=1e-4, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# (a) the attention backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,d", [(200, 200, 64), (384, 384, 128),
                                      (128, 320, 64), (128, 320, 128)])
def test_attention_backward_matches_pallas(sq, skv, d):
    """The Function's gradients against jax.vjp of the Pallas custom VJP,
    and the plain recurrences against _flash_attention_bwd_impl fed the
    same O and logsumexp (200 pads to the TPU block; 128 x 320 is the
    rectangular form).  rtol 1e-4 for the sums over up to 384 keys."""
    rng = np.random.default_rng(sq + skv + d)
    q, g = (rng.normal(size=(2, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(2, skv, d)).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_flash_attention, jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v))
        ref = vjp(jnp.asarray(g))
        o, lse = _flash_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
        ref_impl = _flash_attention_bwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
            jnp.asarray(g))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = flash_attention(tq, tk, tv)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    for a, b in zip(got, ref):
        _close(a, b)
    plain = flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(o), _t(lse),
                                      _t(g))
    for a, b in zip(plain, ref_impl):
        _close(a, b)


# --------------------------------------------------------------------------
# (b) the VJPs of the GroupNorm and fused-conv ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_silu_vjp_matches_jax(apply_silu):
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(2, 6, 5, 64)) + 0.3).astype(np.float32)
    sc = (rng.normal(size=(64,)) * 0.2 + 1).astype(np.float32)
    bi = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_group_norm_silu(
        *a, num_groups=8, apply_silu=apply_silu), *map(jnp.asarray,
                                                       (x, sc, bi)))
    ins = (_t(x, True), _t(sc, True), _t(bi, True))
    y = group_norm_silu(*ins, num_groups=8, apply_silu=apply_silu)
    _close(y, out)
    for a, b in zip(torch.autograd.grad(y, ins, _t(g)), vjp(jnp.asarray(g))):
        _close(a, b)


@pytest.mark.parametrize("variant", ["plain", "residual", "shortcut"])
def test_gn_silu_conv3x3_vjp_matches_jax(variant):
    """Gradients to every tensor input: x, the GN scale and bias, the HWIO
    kernel, the bias, the residual, the shortcut kernel and its bias."""
    rng = np.random.default_rng(12)
    cin, cout = 32, (48 if variant == "shortcut" else 32)
    arrs = [rng.normal(size=(2, 7, 6, cin)),
            rng.normal(size=(cin,)) * 0.2 + 1, rng.normal(size=(cin,)) * 0.1,
            rng.normal(size=(3, 3, cin, cout)) * 0.05,
            rng.normal(size=(cout,)) * 0.1]
    if variant == "residual":
        arrs.append(rng.normal(size=(2, 7, 6, cout)))
    if variant == "shortcut":
        arrs += [rng.normal(size=(2, 7, 6, cin)),
                 rng.normal(size=(cin, cout)) * 0.1,
                 rng.normal(size=(cout,)) * 0.1]
    arrs = [a.astype(np.float32) for a in arrs]
    g = rng.normal(size=(2, 7, 6, cout)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_gn_silu_conv3x3(*a, num_groups=8),
                       *map(jnp.asarray, arrs))
    ins = [_t(a, True) for a in arrs]
    y = gn_silu_conv3x3(*ins, num_groups=8)
    assert y.grad_fn is not None
    _close(y, out)
    for a, b in zip(torch.autograd.grad(y, ins, _t(g)), vjp(jnp.asarray(g))):
        _close(a, b)


# --------------------------------------------------------------------------
# (c) the losses and their gradients
# --------------------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(13)
    logits = (rng.normal(size=(4, 12)) * 3).astype(np.float32)
    targets = (rng.uniform(size=(4, 12)) < 0.3).astype(np.float32) * \
        rng.uniform(0.5, 1, size=(4, 12)).astype(np.float32)
    z = [rng.normal(size=(4, 2, 2, 3)).astype(np.float32) for _ in range(3)]
    labels = [(rng.uniform(size=(4, 12)) < 0.4).astype(np.float32)
              for _ in range(2)]
    return logits, targets, z, labels


def _grad_pair(jfn, tfn, arrays):
    """(value, grads) of a scalar loss in both frameworks."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [_t(a, True) for a in arrays]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts)
    _close(tv, jv)
    for a, b in zip(tg, jg):
        _close(a, b)


@pytest.mark.parametrize("name", ["bce", "focal", "class_balanced"])
def test_classification_losses_match_jax(name):
    logits, targets, _, _ = _loss_inputs()
    counts = np.arange(12) * 3
    np.testing.assert_allclose(cls.class_balanced_weights(counts),
                               np.asarray(jcls.class_balanced_weights(counts)),
                               rtol=1e-6)
    w = cls.class_balanced_weights(counts)
    fns = {"bce": (jcls.bce_with_logits, cls.bce_with_logits),
           "focal": (lambda x, t: jcls.focal_loss(x, t, 0.8, 2.0),
                     lambda x, t: cls.focal_loss(x, t, 0.8, 2.0)),
           "class_balanced": (
               lambda x, t: jcls.class_balanced_loss(x, t, jnp.asarray(w)),
               lambda x, t: cls.class_balanced_loss(x, t, w))}
    jfn, tfn = fns[name]
    _grad_pair(lambda x: jfn(x, jnp.asarray(targets)),
               lambda x: tfn(x, _t(targets)), [logits])


@pytest.mark.parametrize("kind", ["triplet", "triplet_unweighted",
                                  "contrastive"])
@pytest.mark.parametrize("sim", ["cosine", "euclidean"])
def test_metric_losses_match_jax(kind, sim):
    _, _, z, (la, lp) = _loss_inputs()
    if kind == "contrastive":
        # half the pairs similar: the first two positives copy the anchors
        lp = lp.copy()
        lp[:2] = la[:2]
        jfn = lambda a, p: jml.contrastive_loss(  # noqa: E731
            a, p, jnp.asarray(la), jnp.asarray(lp), 0.7, sim)
        tfn = lambda a, p: ml.contrastive_loss(  # noqa: E731
            a, p, _t(la), _t(lp), 0.7, sim)
        _grad_pair(jfn, tfn, z[:2])
        return
    lab = (None, None) if kind == "triplet_unweighted" else (la, lp)
    jl = [None if a is None else jnp.asarray(a) for a in lab]
    tl = [None if a is None else _t(a) for a in lab]
    _grad_pair(lambda a, p, n: jml.triplet_loss(a, p, n, *jl, 1.0, sim),
               lambda a, p, n: ml.triplet_loss(a, p, n, *tl, 1.0, sim), z)


@pytest.mark.parametrize("contrastive", [False, True])
def test_simplified_combined_loss_matches_jax(contrastive):
    logits, targets, z, (la, lp) = _loss_inputs()
    kw = dict(triplet_weight=0.7, use_focal_loss=True,
              use_contrastive=contrastive,
              contrastive_weight=0.4 if contrastive else 0.0)
    jcfg, tcfg = jcomb.LossConfig(**kw), comb.LossConfig(**kw)

    def jfn(a, p, n, x):
        total, _ = jcomb.simplified_combined_loss(
            jcfg, a, p, n, x, jnp.asarray(targets), jnp.asarray(la),
            jnp.asarray(lp))
        return total

    def tfn(a, p, n, x):
        total, d = comb.simplified_combined_loss(
            tcfg, a, p, n, x, _t(targets), _t(la), _t(lp))
        assert set(d) == {"contrastive_loss" if contrastive
                          else "triplet_loss", "classification_loss",
                          "total_loss"}
        return total

    if contrastive:  # the negative takes no part
        _grad_pair(lambda a, p, x: jfn(a, p, None, x),
                   lambda a, p, x: tfn(a, p, None, x), [z[0], z[1], logits])
    else:
        _grad_pair(jfn, tfn, [*z, logits])
    np.testing.assert_array_equal(
        comb.compute_class_distribution(la),
        np.asarray(jcomb.compute_class_distribution(la)))


# --------------------------------------------------------------------------
# (d) the schedules, (e) clip + AdamW with accumulation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["constant", "constant_with_warmup",
                                  "linear", "cosine", "cosine_with_restarts",
                                  "polynomial"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax(name, warmup):
    jfn = jax_schedule(name, 2e-3, warmup, 12)
    fn = build_lr_schedule(name, 2e-3, warmup, 12)
    got = [fn(s) for s in range(16)]
    want = [float(jfn(s)) for s in range(16)]
    # optax evaluates in float32: atol ~ lr * 2^-24
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)


def test_unknown_lr_schedule_raises():
    with pytest.raises(ValueError):
        build_lr_schedule("step", 1e-3, 0, 10)


def test_optimizer_matches_optax():
    """10 micro-steps at accumulation 2 = 5 updates of clip(1.0) + AdamW
    (weight decay 0.01, a warmup + cosine schedule) from the same
    parameters and gradients; the gradients' norms (~2-6) engage the
    clipping.  rtol and atol 1e-6: fp32 rounding of parameters of size
    ~3 over five updates, and the clip divides by norm + 1e-6 in torch."""
    rng = np.random.default_rng(14)
    p0 = {"w": rng.normal(size=(5, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 1.5).astype(np.float32)
              for k, v in p0.items()} for _ in range(10)]
    tx = jax_optimizer(jax_schedule("cosine", 5e-2, 2, 5), 0.01, 1.0, 2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt = build_optimizer(tp.values(), build_lr_schedule("cosine", 5e-2, 2,
                                                         5), 0.01, 1.0, 2)
    applied = []
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = _t(g[k]) if p.grad is None else p.grad + _t(g[k])
        applied.append(opt.step())
        for k in p0:
            _close(tp[k], jp[k], rtol=1e-6, atol=1e-6)
    assert applied == [False, True] * 5 and opt.count == 5


# --------------------------------------------------------------------------
# (f) triplet mining, the split and the batch order
# --------------------------------------------------------------------------

@pytest.fixture
def tagged(tmp_path):
    rng = np.random.default_rng(15)
    tags = [f"t{i}" for i in range(10)]
    (tmp_path / "tags.csv").write_text(
        "name,count\n" + "".join(f"{t},1\n" for t in tags))
    data = {}
    for i in range(37):
        chosen = rng.choice(10, size=rng.integers(0, 4), replace=False)
        data[f"img_{i}.png"] = ", ".join(
            f"t{c}:{rng.uniform(0.2, 1):.2f}" if c % 3 else f"t{c}"
            for c in chosen) + (", unknown_tag" if i % 5 == 0 else "")
    (tmp_path / "data.json").write_text(__import__("json").dumps(data))
    return str(tmp_path / "data.json"), str(tmp_path / "tags.csv")


@pytest.mark.parametrize("seed", [0, 42])
def test_triplet_mining_matches_jax(tagged, seed):
    jds = JaxDataset(*tagged, resolution=32, seed=seed)
    ds = TaggedImageDataset(*tagged, resolution=32, seed=seed)
    np.testing.assert_array_equal(ds.labels_matrix, jds.labels_matrix)
    prompt = "t1:0.5, t2, t3:bad, nope, , t4: 0.25"
    np.testing.assert_array_equal(
        parse_weighted_tags(prompt, ds.tag_to_idx, 10),
        jax_parse(prompt, jds.tag_to_idx, 10))
    for epoch in (0, 3, -1):
        jds.set_epoch(epoch)
        ds.set_epoch(epoch)
        assert [ds._mine_triplet(i) for i in range(len(ds))] == \
            [jds._mine_triplet(i) for i in range(len(jds))]


@pytest.mark.parametrize("n,seed", [(37, 42), (10, 0), (1, 7)])
def test_split_and_batch_order_match_jax(tagged, n, seed):
    assert train_val_split(n, 0.1, seed) == jax_split(n, 0.1, seed)
    jds = JaxDataset(*tagged, resolution=32, seed=seed)
    train, _ = train_val_split(37, 0.1, seed)
    for epoch in (0, 2):
        js = JaxSampler(jds, 4, shuffle=True, seed=seed, indices=train)
        ts = BucketBatchSampler(jds, 4, shuffle=True, seed=seed,
                                indices=train)
        js.set_epoch(epoch)
        ts.set_epoch(epoch)
        want = [[i for i, m in zip(chunk, mask) if m] for chunk, mask in js]
        assert list(ts) == want and len(ts) == len(js)


# --------------------------------------------------------------------------
# (g) BatchNorm running statistics after a train-mode forward
# --------------------------------------------------------------------------

def test_batchnorm_running_stats_match_flax():
    """The head in train mode moves its running statistics as flax's
    BatchNorm(momentum=0.9) does, with the biased batch variance (torch's
    own update would take the unbiased one: n/(n-1) = 16/15 here)."""
    rng = np.random.default_rng(16)
    z = rng.normal(size=(1, 4, 4, 16)).astype(np.float32)
    jhead = JaxAttnHead(latent_channels=16, num_classes=5,
                        attention=JaxAttnCfg())
    variables = jax.jit(jhead.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(0)}, jnp.zeros((1, 4, 4, 16)),
        deterministic=True)
    stats = {"feature_compress_1": {
        "mean": rng.normal(size=(8,)).astype(np.float32) * 0.1,
        "var": rng.uniform(0.5, 1.5, size=(8,)).astype(np.float32)}}
    _, mutated = jax.jit(lambda v, x: jhead.apply(
        v, x, deterministic=False, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(1)}))(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(z))
    head = AttentionClassificationDecoder(16, 5, AttentionDecoderConfig())
    head.load_state_dict(torch_state_from_jax_params(
        jax.device_get(variables["params"]), stats), strict=False)
    head.train()(torch.from_numpy(z), torch.Generator().manual_seed(0))
    bn = head.feature_compress[1]
    new = mutated["batch_stats"]["feature_compress_1"]
    _close(bn.running_mean, new["mean"], rtol=0)
    _close(bn.running_var, new["var"], rtol=0)
