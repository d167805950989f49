"""The readers of the program's own spans and counters (yardstick/program.py;
metrics graph_run_us, loop_idle_pct, input_copies, fwd_ms, bwd_ms, opt_ms)
on a synthetic trace and synthetic counters, and nothing where the program
recorded nothing or has no tracing."""

import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from yardstick import cells
from yardstick.trace import Trace

from geobignn_tpu_torch import tracing

SPAN_METRICS = ("graph_run_us", "loop_idle_pct")
COUNTER_METRICS = ("input_copies", "fwd_ms", "bwd_ms", "opt_ms")


def _trace():
    """A 1,000 us window: an epoch's loop 100-800 us holding two graph
    calls (100-150, 400-500) with their launches (120-140, 430-490); device
    busy 140-390 and 450-700, so idle 100-140, 390-450 and 700-800 inside
    the loop, 0-100 and 800-1000 outside."""
    device = [("k", 140.0, 390.0), ("k", 450.0, 700.0), ("early", -50.0, 0.0)]
    host = [("bench.window", 0.0, 1000.0), ("trainer.epoch", 20.0, 980.0),
            ("trainer.steps", 100.0, 800.0), ("graph.run", 100.0, 150.0),
            ("graph.run", 400.0, 500.0), ("graph.replay", 120.0, 140.0),
            ("graph.replay", 430.0, 490.0), ("aten::fill_", 30.0, 60.0)]
    return Trace(sorted(device, key=lambda t: t[1]), host, (0.0, 1000.0))


def _ctx(trace, mode="train"):
    return dict(mode=mode, spans={}, counters={}, trace=trace)


@pytest.fixture
def counted():
    """The counters one traced window of two replayed steps would leave."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            tracing.count("graph.runs")
            tracing.count("graph.input_tensors", 99)
        tracing.count("step.fwd_ms", 3.5)
        tracing.count("step.bwd_ms", 6.25)
        tracing.count("step.opt_ms", 0.5)
        tracing.count("step.stage_readings")
    yield
    tracing.reset()


def test_span_readers_on_a_synthetic_trace():
    tr = _trace()
    # the calls' own host time, their launches left out: (50 - 20 + 100 - 60) / 2
    assert cells.reader("graph_run_us.patch")(_ctx(tr)) == pytest.approx(35.0)
    loop = cells.reader("loop_idle_pct.patch")(_ctx(tr))
    idle = cells.reader("idle_pct.patch")(_ctx(tr))
    assert loop == pytest.approx(100.0 * (40 + 60 + 100) / 1000)
    assert idle == pytest.approx(100.0 * (100 + 40 + 60 + 100 + 200) / 1000)
    assert loop <= idle


def test_a_launch_outside_a_call_is_not_taken_from_it():
    tr = _trace()
    tr.host = tr.host + [("graph.replay", 600.0, 700.0), ("graph.replay", 140.0, 160.0)]
    assert cells.reader("graph_run_us.whole")(_ctx(tr)) == pytest.approx(35.0)


def test_the_eval_loop_counts_as_a_loop():
    tr = _trace()
    tr.host = [(("trainer.eval_steps" if n == "trainer.steps" else n), s, e)
               for n, s, e in tr.host]
    assert cells.reader("loop_idle_pct.eval")(_ctx(tr, "eval")) == pytest.approx(20.0)


def test_counter_readers(counted):
    ctx = _ctx(_trace())
    assert cells.reader("input_copies.whole")(ctx) == 99
    assert cells.reader("fwd_ms.whole")(ctx) == 3.5
    assert cells.reader("bwd_ms.patch")(ctx) == 6.25
    assert cells.reader("opt_ms.patch")(ctx) == 0.5


@pytest.mark.parametrize("metric", SPAN_METRICS + COUNTER_METRICS)
def test_nothing_without_a_span_or_counter(metric):
    """A window in which the program recorded nothing, or no trace at all."""
    tracing.reset()
    bare = Trace([("k", 0.0, 10.0)], [("bench.window", 0.0, 100.0)], (0.0, 100.0))
    for trace in (bare, None):
        assert cells.reader(metric + ".patch")(_ctx(trace)) is None


@pytest.mark.parametrize("metric", COUNTER_METRICS)
def test_nothing_from_a_program_without_tracing(metric, counted, monkeypatch):
    """A program from before tracing.py (the parent of this benchmark's
    program metrics): the import fails, the metric reads None."""
    import geobignn_tpu_torch

    monkeypatch.delattr(geobignn_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "geobignn_tpu_torch.tracing", None)
    assert cells.reader(metric + ".patch")(_ctx(_trace())) is None
