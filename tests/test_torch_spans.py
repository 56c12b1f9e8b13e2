"""The port's own spans (utils/profiling.py): under a profiler the engine
places a batch in ``engine.place`` before the encode's ranges, the train
step's phases nest as documented, and every ``ops/`` call on the models'
path opens its ``op.*`` range (the set of ranges of an encode and of a
train step is pinned, so a range that moves fails here); with no
profiler no range is entered and the outputs do not change.  CPU only,
a FLUX-shaped VAE cut to two levels of one ResnetBlock at 16px."""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vae_tagger_tpu_torch.core.config import (
    AttentionDecoderConfig,
    default_flux_vae_config,
)
from vae_tagger_tpu_torch.infer.engine import TaggerEngine, build_decoder
from vae_tagger_tpu_torch.losses.combined import LossConfig
from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
from vae_tagger_tpu_torch.models.taggers import AttentionClassificationDecoder
from vae_tagger_tpu_torch.nn.blocks import seeded_init_
from vae_tagger_tpu_torch.ops.image import rgb_to_yuv420_reference
from vae_tagger_tpu_torch.train.state import TrainState
from vae_tagger_tpu_torch.train.steps import FullSteps
from vae_tagger_tpu_torch.utils import profiling

RES, B, TAGS = 16, 2, 6
CFG = default_flux_vae_config(block_out_channels=(8, 16),
                              down_block_types=("DownEncoderBlock2D",) * 2,
                              up_block_types=("UpDecoderBlock2D",) * 2,
                              layers_per_block=1, norm_num_groups=4,
                              latent_channels=4, sample_size=RES)
# ResnetBlocks of the encoder: 2 levels of 1, and 2 in the mid-block
RESNETS = 4


def _engine():
    vae = seeded_init_(AutoencoderKL(CFG), 1)
    head = build_decoder(TAGS, True, dict(attention_heads=2), 4, seed=0)
    return TaggerEngine(vae, head, [f"tag_{i}" for i in range(TAGS)],
                        device="cpu")


def _pixels(seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(B, RES, RES, 3), dtype=np.uint8)


class _SGD:
    """In the optimizer's place, plain SGD: AdamW's first construction in a
    process takes seconds."""

    def __init__(self, params):
        self.params = list(params)

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is not None:
                p -= 1e-3 * p.grad
                p.grad = None


def _train_state():
    vae = seeded_init_(AutoencoderKL(CFG), 2)
    head = seeded_init_(AttentionClassificationDecoder(
        4, TAGS, AttentionDecoderConfig(attention_heads=2)), 3)
    opt = _SGD([*vae.parameters(), *head.parameters()])
    return TrainState(vae=vae.train(), decoder=head.train(), optimizer=opt)


def _batch():
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, 256, size=(B, RES, RES, 3), dtype=np.uint8)
             for k in ("anchor", "positive", "negative")}
    for k in ("labels", "positive_labels"):
        batch[k] = (rng.uniform(size=(B, TAGS)) < 0.4).astype(np.float32)
    return batch


def _spans(prof) -> list:
    """The program's ranges of a capture, in the order they opened, read
    from the profiler's raw events (building its event list for every
    operator would take seconds)."""
    spans = [SimpleNamespace(name=e.name(), start=e.start_ns(),
                             end=e.end_ns(), thread=e.start_thread_id())
             for e in prof.kineto_results.events()
             if e.name().startswith(profiling.PREFIX)]
    return sorted(spans, key=lambda e: e.start)


def _name(e) -> str:
    return e.name[len(profiling.PREFIX):]


def _inside(child, parent) -> bool:
    return (child.thread == parent.thread
            and parent.start <= child.start and child.end <= parent.end)


def _one(spans, name):
    found = [e for e in spans if _name(e) == name]
    assert len(found) == 1, (name, Counter(_name(e) for e in spans))
    return found[0]


@pytest.fixture(scope="module")
def engine():
    return _engine()


def test_classify_spans_nest(engine):
    with torch.autograd.profiler.profile() as prof:
        probs, _ = engine.classify_async(_pixels())
    spans = _spans(prof)
    place = _one(spans, "engine.place")
    ops = [e for e in spans if e is not place]
    assert ops and all(_name(o).startswith("op.") for o in ops)
    assert all(place.end <= o.start for o in ops)
    assert _inside(_one(spans, "op.flash_attention_fwd"),
                   _one(spans, "op.spatial_single_head_attention"))
    # the head's pools, after the encoder's attention
    pools = [o for o in ops if _name(o).startswith("op.adaptive_")]
    assert len(pools) == 3
    assert _one(spans, "op.spatial_single_head_attention").end <= min(
        o.start for o in pools)
    assert probs.shape == (B, TAGS)


def test_yuv_placing_holds_its_conversion(engine):
    y, cbcr = zip(*(rgb_to_yuv420_reference(px) for px in _pixels()))
    with torch.autograd.profiler.profile() as prof:
        engine.classify_yuv_async(np.stack(y), np.stack(cbcr))
    spans = _spans(prof)
    place = _one(spans, "engine.place")
    assert _inside(_one(spans, "op.yuv420_to_rgb_uint8"), place)


def test_an_encode_ranges_every_op_on_the_model_path(engine):
    with torch.autograd.profiler.profile() as prof:
        engine.encode_async(_pixels())
    counts = Counter(_name(e) for e in _spans(prof))
    assert counts["op.normalize_uint8"] == 1
    assert counts["op.gn_silu_conv3x3"] == 2 * RESNETS
    # the mid-block attention's GroupNorm and conv_norm_out
    assert counts["op.group_norm_silu"] == 2
    assert counts["op.spatial_single_head_attention"] == 1
    assert counts["op.flash_attention_fwd"] == 1
    # conv_in, the downsample and conv_out, and on the CPU the plain
    # version of each fused conv
    assert counts["op.conv2d_nhwc"] == 3 + 2 * RESNETS
    assert set(counts) == {"engine.place", "op.normalize_uint8",
                           "op.gn_silu_conv3x3", "op.group_norm_silu",
                           "op.spatial_single_head_attention",
                           "op.flash_attention_fwd", "op.conv2d_nhwc"}


@pytest.fixture
def entered(monkeypatch) -> list:
    """The labels of the program's ranges entered from now on."""
    labels = []
    inner = torch.autograd.profiler.record_function

    def counting(name, *args, **kwargs):
        if name.startswith(profiling.PREFIX):
            labels.append(name)
        return inner(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    return labels


def test_no_profiler_enters_no_range_and_changes_no_answer(engine, entered):
    bare, _ = engine.classify_async(_pixels())
    assert not entered
    with torch.autograd.profiler.profile():
        traced, _ = engine.classify_async(_pixels())
    assert entered  # the same path, ranged once a profiler runs
    assert torch.equal(bare, traced)


def test_a_train_step_gives_its_phases_and_backward_ranges(entered):
    """Also: untraced, the step enters no range, and the traced step from
    the same state ends in the same parameters, bit for bit."""
    states = [_train_state(), _train_state()]
    steps = FullSteps(LossConfig(triplet_weight=1.0))
    steps.train_step(states[0], _batch(), 0)
    assert not entered
    with torch.autograd.profiler.profile() as prof:
        steps.train_step(states[1], _batch(), 0)
    for a, b in zip(states[0].vae.parameters(), states[1].vae.parameters()):
        assert torch.equal(a, b)
    spans = _spans(prof)
    step = _one(spans, "steps.train_step")
    phases = [_one(spans, n) for n in ("steps.place", "steps.forward",
                                       "steps.backward", "steps.optimizer")]
    assert all(_inside(p, step) for p in phases)
    ends = [(p.start, p.end) for p in phases]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    assert all(_inside(e, step) for e in spans)
    # every op range of the step, forward and backward: on the card the
    # backward of a fused conv adds kernel F's range inside its own
    ops = Counter(_name(e) for e in spans if _name(e).startswith("op."))
    assert ops == {
        "op.normalize_uint8": 1, "op.gn_silu_conv3x3": 2 * RESNETS,
        "op.group_norm_silu": 2, "op.spatial_single_head_attention": 1,
        "op.flash_attention_fwd": 1, "op.adaptive_avg_pool_nhwc": 2,
        "op.adaptive_max_pool_nhwc": 1,
        # the encode's 3 + 2 per ResnetBlock (see above), and the rest
        "op.conv2d_nhwc": 25,
        "op.gn_silu_conv3x3.bwd": 2 * RESNETS, "op.group_norm_silu.bwd": 2,
        "op.flash_attention.bwd": 1}


def test_loop_data_spans_each_next():
    with torch.autograd.profiler.profile() as prof:
        assert list(profiling.spanned(range(3), "loop.data")) == [0, 1, 2]
    # three items, and the wait that found the end
    assert [_name(e) for e in _spans(prof)] == ["loop.data"] * 4
