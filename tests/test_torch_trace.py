"""``volrt_torch.utils.trace``: the program's spans inside a frame and a
training step.

With no profiler recording, a span enters nothing and keeps nothing. Under
a profiler, a rung-5 frame, a rung-3 frame and a fused train step record
the spans of their layers, nested, one call index a frame or step, under
the names the profiler's own events carry and on its clock. The test
marked ``card`` holds a device stage's stream time to the kernels the
profiler saw it launch; it skips without a card. On the card:

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_trace.py
"""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volrt_torch.bench.harness import synthetic_volume
from volrt_torch.core.tf import default_transfer_fn
from volrt_torch.core.types import Volume, make_raycaster
from volrt_torch.core.view import Camera
from volrt_torch.diff.render import DiffScene
from volrt_torch.renderers import fwd_v3, trilinear
from volrt_torch.renderers.diff_v3 import l2_loss_grads_v3_onepass
from volrt_torch.train.fit import init_state, make_optimizer, make_train_step
from volrt_torch.utils import trace

# Each call's spans in the order they open: (name, its parent's name).
SPANS = {
    "rung5": [("render", None), ("volume_copy", "render"),
              ("ray_setup", "render"), ("march", "render")],
    "rung3": [("render", None), ("volume_copy", "render"),
              ("ray_setup", "render"), ("leap", "ray_setup"),
              ("march", "render")],
    "step": [("train_step", None), ("volume_copy", "train_step"),
             ("ray_setup", "train_step"), ("march", "train_step"),
             ("loss", "train_step"), ("optimizer", "train_step")],
}


def make_calls(device: torch.device, n: int = 12, px: int = 8) -> dict:
    """The three calls on an ``n``^3 synthetic volume and a ``px``^2
    viewport: rung 5's phong frame with ESL, rung 3's frame after the
    leap, and a step of the fused trainer (the fast mode's bf16 copy)."""
    vol = Volume.from_numpy(synthetic_volume(n), device)
    view = Camera(dims=(px, px)).view(device)
    rc3 = make_raycaster(vol, view, interpolation="trilinear")
    rc5 = rc3.replace(shading="phong")
    scene = DiffScene(vol.data.to(torch.float32) / 255.0,
                      default_transfer_fn(device), rc3.ray_step)
    state = init_state(scene, make_optimizer(scene))
    step = make_train_step(loss_grads_fn=lambda s, v, t: (
        l2_loss_grads_v3_onepass(s, v, t, fast=True)))
    target = torch.rand((px, px, 4), generator=torch.Generator().manual_seed(
        3)).to(device)
    return {"rung5": lambda: fwd_v3.render_float(rc5),
            "rung3": lambda: trilinear.render_float(rc3),
            "step": lambda: step(state, view, target)}


@pytest.fixture(scope="module")
def calls():
    return make_calls(torch.device("cpu"))


@pytest.fixture
def fresh():
    trace.clear()
    yield
    trace.clear()


def recorded(call, times: int = 2, activities=(ProfilerActivity.CPU,)):
    """Run ``call`` ``times`` times under a profiler -> (its records, the
    profiler's trace start in ns, its host events by name, in order)."""
    call()
    trace.clear()
    with profile(activities=list(activities)) as prof:
        for _ in range(times):
            call()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if (e.name.startswith(trace.PREFIX)
                and e.device_type == torch.autograd.DeviceType.CPU):
            events.setdefault(e.name, []).append(e)
    return trace.records(), start_ns, events


@pytest.mark.parametrize("name", sorted(SPANS))
def test_no_profiler_records_nothing(monkeypatch, calls, fresh, name):
    """No span opens a profiler range (the spans' own, nor
    ``record_function``, which Adam's ``step`` enters whatever records)
    or creates a CUDA event."""
    real = torch.autograd.profiler.record_function

    def record_function(span_name, *args, **kwargs):
        assert not span_name.startswith(trace.PREFIX), span_name
        return real(span_name, *args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_function)
    monkeypatch.setattr(trace, "_range", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    for _ in range(2):
        calls[name]()
    assert trace.records() == []


@pytest.mark.parametrize("name", sorted(SPANS))
def test_spans_of_each_layer_nested_one_call_each(calls, fresh, name):
    recs, _, events = recorded(calls[name])
    want = SPANS[name]
    assert [r.name for r in recs] == [trace.PREFIX + s for s, _ in want] * 2
    for k, r in enumerate(recs):
        first = k - k % len(want)
        assert r.call == k // len(want)
        parent = want[k % len(want)][1]
        if parent is None:
            assert r.parent is None
        else:
            p = r.parent
            assert p in recs[first:k] and p.name == trace.PREFIX + parent
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        assert r.events is None and r.stream_ms is None  # the CPU
        assert r.work == {"voxels": 12 ** 3, "parameters": 12 ** 3 + 128 * 4
                          }.get(r.unit, 64)
    for span_name, rs in events.items():
        assert len(rs) == sum(r.name == span_name for r in recs)
    assert set(events) == {r.name for r in recs}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_records_are_on_the_profiler_s_clock(calls, fresh, name):
    recs, start_ns, events = recorded(calls[name])
    seen = {}
    for r in recs:
        k = seen[r.name] = seen.get(r.name, -1) + 1
        ev = events[r.name][k]
        assert abs((r.start_ns - start_ns) / 1e3 - ev.time_range.start) < 1e3
        assert abs((r.end_ns - start_ns) / 1e3 - ev.time_range.end) < 1e3


def test_summary_per_call(calls, fresh):
    recs, _, _ = recorded(calls["step"], times=3)
    assert trace.call_ids() == [0, 1, 2]
    every, first = trace.summary(), trace.summary([0])
    assert every[trace.PREFIX + "march"].calls == 3
    assert first[trace.PREFIX + "march"].calls == 1
    for s in first.values():
        assert s.spans == 1 and s.host_ms > 0.0 and s.stream_ms is None
    rays = every[trace.PREFIX + "ray_setup"]
    assert (rays.unit, rays.work, rays.spans) == ("rays", 64.0, 3)
    assert rays.host_ms == pytest.approx(sum(
        r.host_ms for r in recs if r.name == rays.name) / 3)
    last = trace.summary([2])[rays.name]
    assert last.host_ms == pytest.approx(
        [r for r in recs if r.name == rays.name][2].host_ms)


def test_a_long_profile_keeps_the_newest_calls(monkeypatch, fresh):
    """Under a profiler held around many calls, the records keep the last
    ``KEEP_CALLS`` to ``2 * KEEP_CALLS`` top-level calls, each whole."""
    monkeypatch.setattr(trace, "KEEP_CALLS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(20):
            with trace.span("top", rays=i):
                with trace.span("inner"):
                    pass
            ids = trace.call_ids()
            assert ids == list(range(i + 1 - len(ids), i + 1))
            assert len(ids) == (i + 1 if i < 6 else 4 + (i - 6) % 3)
            assert len(trace.records()) == 2 * len(ids)
    recs = trace.records()
    assert [r.work for r in recs if r.parent is None] == list(
        range(20 - len(trace.call_ids()), 20))
    assert all(r.parent in recs for r in recs if r.parent is not None)


def test_a_span_that_raises_closes(fresh):
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("inner", rays=4):
                    raise ValueError("stop")
        with trace.span("after"):
            pass
        with pytest.raises(ValueError):
            trace.span("two", rays=1, voxels=2)
    outer, inner, after = trace.records()
    assert inner.parent is outer and inner.end_ns is not None
    assert after.parent is None and after.call == 1


def test_bench_trace_dir_keeps_the_spans(tmp_path, fresh):
    """``cli bench --trace-dir``: each cell's Chrome trace shows the
    program's spans, whose records are then dropped."""
    from volrt_torch.bench import harness
    from volrt_torch.utils.logger import Logger

    harness.run_suite([harness.BenchConfig("tiny_8", volume_size=8,
                                           viewport=16)],
                      renderers=(3, 5), frames=2,
                      logger=Logger(path=None, quiet=True),
                      trace_dir=str(tmp_path), device="cpu")
    for rung in ("pallas-trilinear", "pallas-v3"):
        text = (tmp_path / f"tiny_8_{rung}.json").read_text()
        for span_name in ("render", "volume_copy", "ray_setup", "march"):
            assert f'"{trace.PREFIX}{span_name}"' in text, (rung, span_name)
    assert trace.records() == []


def test_trace_step_counts_overlapping_device_time_once():
    from volrt_torch.bench.trace_step import busy_us, launches

    assert set(launches()) == {"march_fwd", "march_bwd", "l2_step",
                               "march_tri", "march_blocked", "esl_start",
                               "ray_setup", "adam_step"}
    assert busy_us([]) == 0.0
    assert busy_us([(5.0, 9.0), (0.0, 2.0), (1.0, 3.0), (8.0, 8.5)]) == 7.0
    assert busy_us([(0.0, 10.0), (2.0, 3.0)]) == 10.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _device_us(event) -> float:
    """Device time of the operations launched under ``event``'s subtree of
    host events (the spans' own ranges on the device left out)."""
    own = sum(k.duration for k in event.kernels
              if not k.name.startswith(trace.PREFIX))
    return own + sum(_device_us(ch) for ch in event.cpu_children)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SPANS))
def test_ray_setup_stream_ms_holds_its_kernels(card, fresh, name):
    """The stream's time between the ray setup's two events is at least
    the device time of the kernels the profiler saw launched under it."""
    calls = make_calls(card, n=128, px=512)
    recs, _, events = recorded(calls[name], times=3, activities=(
        ProfilerActivity.CPU, ProfilerActivity.CUDA))
    torch.cuda.synchronize(card)
    setups = [r for r in recs if r.name == trace.PREFIX + "ray_setup"]
    assert len(setups) == len(events[trace.PREFIX + "ray_setup"]) == 3
    for r, ev in zip(setups, events[trace.PREFIX + "ray_setup"]):
        device_us = _device_us(ev)
        assert device_us > 0.0
        # Two clocks: the events' resolution is about half a microsecond.
        assert r.stream_ms * 1e3 >= device_us - 2.0, (r.stream_ms, device_us)
