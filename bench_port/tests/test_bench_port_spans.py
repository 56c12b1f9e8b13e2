"""The readers of the program's own spans (program_spans.py): the idle
overlap and the inside/glue split on synthetic events, None where the
program opened no span, traced CPU runs of the tiny cells, and on the card
the spans held to the device's records of a traced run."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from bench_port import program_spans, run, spec
from bench_port.program_spans import ProgramSpans

from .conftest import REPO


def _event(name, start, end, device=DeviceType.CPU, thread=1, id=0,
           annotation=False):
    return SimpleNamespace(
        name=name, device_type=device, thread=thread, id=id,
        is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def _kernel(id, start, end, name="kernel"):
    return _event(name, start, end, DeviceType.CUDA, thread=7, id=id)


WINDOW = _event("bench:window", 0, 100)


def test_idle_overlap_and_mean_of_a_span():
    events = [
        WINDOW,
        _kernel(1, 10, 30), _kernel(2, 50, 60),
        _event("vt:engine.place", 25, 45), _event("vt:engine.place", 55, 70),
        # annotations on the device's timeline are no device work
        _event("vt:engine.place", 20, 80, DeviceType.CUDA, annotation=True),
        _event("bench:classify_async", 0, 100, DeviceType.CUDA),
        # a span opened before the window is not the window's
        _event("vt:engine.place", -20, -5),
    ]
    spans = ProgramSpans(events)
    # idle: 0-10, 30-50, 60-100; the spans hold 30-45 and 60-70 of it
    assert spans.idle_overlap_pct("engine.place") == pytest.approx(25.0)
    assert spans.mean_ms("engine.place") == pytest.approx((20 + 15) / 2e3)


def test_a_launch_is_placed_by_its_thread_and_time():
    events = [
        WINDOW,
        # the main thread's op range, and one on autograd's thread (2)
        _event("vt:op.gn_silu_conv3x3", 10, 40, thread=1),
        _event("vt:op.gn_silu_conv3x3.bwd", 50, 70, thread=2),
        # launches: inside on thread 1; at the same time on thread 2,
        # where no range is open; inside thread 2's range; after the range
        _event("cudaLaunchKernel", 20, 21, thread=1, id=100),
        _event("cuLaunchKernel", 20, 21, thread=2, id=101),
        _event("cudaMemcpyAsync", 60, 61, thread=2, id=102),
        _event("cudaLaunchKernel", 45, 46, thread=1, id=103),
        # an op that launches nothing by itself is no launch call
        _event("aten::add", 30, 31, thread=1, id=104),
        _kernel(100, 22, 30), _kernel(101, 30, 34), _kernel(102, 62, 63),
        _kernel(103, 46, 50),
        # device work no launch call in the trace joins
        _kernel(105, 80, 90),
    ]
    spans = ProgramSpans(events)
    assert spans.in_op(1, 20) and not spans.in_op(2, 20)
    assert spans.in_op(2, 60) and not spans.in_op(1, 45)
    split = spans.device_split()
    assert split["inside"] == pytest.approx((8 + 1) / 1e6)
    assert split["glue"] == pytest.approx((4 + 4) / 1e6)
    assert split["unjoined"] == pytest.approx(10 / 1e6)
    assert split["total"] == pytest.approx(27 / 1e6)
    assert ProgramSpans(events).glue_pct() == pytest.approx(100 * 8 / 27)


def test_no_program_span_reads_none():
    events = [WINDOW, _kernel(1, 10, 30),
              _event("cudaLaunchKernel", 5, 6, id=1),
              _event("bench:op:gn_silu_conv3x3", 4, 8)]
    spans = ProgramSpans(events)
    assert spans.mean_ms("engine.place") is None
    assert spans.idle_overlap_pct("engine.place") is None
    assert spans.glue_pct() is None


def test_no_device_work_reads_none():
    events = [WINDOW, _event("vt:engine.place", 10, 20),
              _event("vt:op.conv2d_nhwc", 30, 40)]
    spans = ProgramSpans(events)
    assert spans.mean_ms("engine.place") == pytest.approx(0.01)
    assert spans.idle_overlap_pct("engine.place") is None
    assert spans.glue_pct() is None


def test_traced_infer_run_lists_what_the_cpu_has(tiny_root, two_threads):
    out = run.execute(spec.load("tiny.fp32.infer", tiny_root), 2 ** 33 + 7,
                      1.5, True, "cpu")
    assert out["correct"]
    assert out["metrics"]["engine.place_ms.infer"]["value"] > 0
    # no device work is traced on the CPU
    assert "engine.place_idle_pct.infer" not in out["metrics"]
    assert "ops.glue_pct.infer" not in out["metrics"]


def test_traced_train_run_holds_the_steps_spans(tiny_root, two_threads):
    cell = spec.load("tiny.fp32.train", tiny_root)
    ctx = run.Context(cell, 2 ** 33 + 9, 1.5, True, "cpu")
    cell.traffic().run(ctx)
    spans = program_spans.of(ctx)
    for name in ("steps.train_step", "steps.place", "steps.forward",
                 "steps.backward", "steps.optimizer",
                 "op.gn_silu_conv3x3", "op.gn_silu_conv3x3.bwd"):
        assert spans.spans[name], name
    assert spans.glue_pct() is None
    assert cell.readers["ops.glue_pct.train"].read(None, ctx) is None
    assert spans.device_split()["total"] == 0


# the cells at a size a test run holds (the tensor-core attention takes the
# published head width, so the tiny cells do not run on the card)
CARD_CELLS = {
    "flux1-dev.bf16.infer-b8": ("ops.glue_pct.infer.bf16", dict(
        resolution=256, bank_images=16, check_images=8, trace_seconds=1)),
    "flux1-dev.bf16.train_full-1024": ("ops.glue_pct.train", dict(
        resolution=256, triplets=2, host_batches=2, trace_seconds=1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CARD_CELLS))
def test_the_spans_hold_to_the_device_on_the_card(card, monkeypatch, cell):
    """A traced run through ``run.execute`` on the card: every device-side
    record named after a program span is marked an annotation (so no
    reader counts it as device work), all the window's device time joins
    a launch call and splits into inside + glue, and each batch's
    host-to-device copy starts on the device after its ``engine.place``
    span opened on the host (one clock)."""
    glue, size = CARD_CELLS[cell]
    c = spec.load(cell, REPO)
    c.workload["params"].update(size)
    seen, of = [], program_spans.of
    monkeypatch.setattr(program_spans, "of",
                        lambda ctx: seen.append(ctx) or of(ctx))
    out = run.execute(c, 2 ** 33 + 11, 1.5, True, card)
    assert 0 < out["metrics"][glue]["value"] < 100
    ctx = seen[0]
    spans = of(ctx)
    split = spans.device_split()
    assert split["inside"] > 0 and split["glue"] > 0
    assert split["inside"] + split["glue"] == pytest.approx(
        split["total"], rel=5e-3)
    events = ctx.tracer.prof.events()
    marked = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name.startswith(program_spans.PREFIX)]
    assert marked and all(e.is_user_annotation for e in marked)
    if "infer" in cell:
        starts = {e.id: e.time_range.start for e in events
                  if e.device_type == DeviceType.CUDA}
        copies = [(a, starts[cid]) for a, b, thread in
                  spans.spans["engine.place"]
                  for start, t, cid, call in spans.calls
                  if t == thread and a <= start <= b
                  and call.startswith("cudaMemcpy") and cid in starts]
        assert copies and all(a <= d for a, d in copies)
