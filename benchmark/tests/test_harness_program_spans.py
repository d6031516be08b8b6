"""The readers of the program's own spans and counters
(``benchmark/program_spans.py`` and the metrics that use it): the values
worked out by hand on a trace built by hand, None where the program has no
such span or counter (an older program), and a tiny CPU run of each cell
with ``--trace 1``."""

import sys
import types

import pytest

from benchmark import harness, program_spans, spec
from benchmark.tracing import CpuEvent, DeviceEvent, Trace

TRAIN_METRICS = ("dense_apply_idle_ms.train", "sparse_update_idle_ms.train",
                 "dedup_idle_ms.train", "backward_idle_ms.train",
                 "host_syncs.train", "prefetch_wait_ms.train",
                 "prefetch_empty_share.train", "host_tier_mb.train")
SERVE_METRICS = ("score_copy_idle_ms.serve",)


def _read(name, ctx):
    return spec.load_module("metrics", name).read(ctx)


def _ev(i, name, thread, start, end, annotation=True, parent=None):
    return CpuEvent(i, name, thread, start, end, parent, [], annotation)


def _train_trace(program=True):
    """Two traced steps, window 0-200 us.  Thread 1 runs the loop, thread
    2 the backward.  The gaps and what names them (the middle's innermost
    span): 0-10 prefetch.take, 22-30 bench.step, 50-60 top_mlp.bwd (begun
    after bench.step), 76-84 bottom_mlp.bwd, 110-120 dense_apply, 142-150
    dedup (inside sparse_update, over a sync), 162-168 sparse_update,
    188-200 bench.loss_read.  Syncs: one in the dedup, one under bench.step
    alone, one in the loss read, the closing one under bench.traced, one
    after the window (the profiler's own)."""
    cpu = [_ev(1, "bench.traced", 1, 0, 200),
           _ev(2, "bench.feed", 1, 0, 20),
           _ev(4, "bench.step", 1, 20, 186),
           _ev(10, "cudaStreamSynchronize", 1, 175, 176, False),
           _ev(11, "bench.loss_read", 1, 187, 195),
           _ev(12, "cudaStreamSynchronize", 1, 191, 194, False),
           _ev(13, "cudaDeviceSynchronize", 1, 196, 199, False),
           _ev(14, "cudaDeviceSynchronize", 1, 201, 203, False)]
    if program:
        cpu += [_ev(3, "prefetch.take", 1, 2, 18),
                _ev(5, "dense_apply", 1, 100, 130),
                _ev(6, "aten::mul", 1, 101, 104, False),
                _ev(7, "sparse_update", 1, 130, 170),
                _ev(8, "dedup", 1, 140, 160),
                _ev(9, "cudaStreamSynchronize", 1, 145, 149, False),
                _ev(20, "top_mlp.bwd", 2, 40, 70),
                _ev(21, "aten::mm", 2, 41, 45, False),
                _ev(22, "bottom_mlp.bwd", 2, 70, 90)]
    else:  # an older program: the same work, no span of its own
        cpu += [_ev(9, "cudaStreamSynchronize", 1, 145, 149, False),
                _ev(21, "aten::mm", 2, 41, 45, False)]
    busy = [(10, 22), (30, 50), (60, 76), (84, 110), (120, 142), (150, 162),
            (168, 188)]
    return Trace(cpu, [DeviceEvent("k", a, b) for a, b in busy], (0, 200))


def _ctx(trace, train=True, traced=2):
    return types.SimpleNamespace(trace=trace, traced=[None] * traced,
                                 train=train)


@pytest.fixture
def telemetry(monkeypatch):
    """The program's telemetry module as the readers find it, with the
    counters given (None: a module without counters)."""
    def put(counts):
        mod = types.ModuleType(program_spans.TELEMETRY)
        if counts is not None:
            mod.counters = lambda: dict(counts)
        monkeypatch.setitem(sys.modules, program_spans.TELEMETRY, mod)
    return put


def test_readers_give_the_hand_worked_values(telemetry):
    telemetry({"prefetch.takes": 8, "prefetch.empty": 2,
               "host_tier.gather_bytes": 3_000_000,
               "host_tier.update_bytes": 1_000_000})
    ctx = _ctx(_train_trace())
    want = {"dense_apply_idle_ms.train": 10 / 2e3,
            "sparse_update_idle_ms.train": 6 / 2e3,
            "dedup_idle_ms.train": 8 / 2e3,
            "backward_idle_ms.train": (10 + 8) / 2e3,
            "host_syncs.train": 2 / 2,
            "prefetch_wait_ms.train": 16 / 2e3,
            "prefetch_empty_share.train": 25.0,
            "host_tier_mb.train": 4.0 / 2}
    for name, value in want.items():
        assert _read(name, ctx) == pytest.approx(value), name
    # the training metrics say nothing of a scoring run
    assert all(_read(n, _ctx(ctx.trace, train=False)) is None
               for n in TRAIN_METRICS)


def test_score_copies_idle_by_hand(telemetry):
    telemetry({})
    cpu = [_ev(1, "bench.traced", 1, 0, 100),
           _ev(2, "bench.score_batch", 1, 0, 100),
           _ev(3, "score_batch.h2d", 1, 0, 20),
           _ev(4, "lookup", 1, 20, 40),
           _ev(5, "score_batch.readback", 1, 80, 100)]
    dev = [DeviceEvent("Memcpy HtoD", 5, 15), DeviceEvent("gemm", 20, 80),
           DeviceEvent("Memcpy DtoH", 85, 88)]
    ctx = _ctx(Trace(cpu, dev, (0, 100)), train=False, traced=1)
    assert _read("score_copy_idle_ms.serve", ctx) == \
        pytest.approx((5 + 5 + 5 + 12) / 1e3)
    assert _read("score_copy_idle_ms.serve", _ctx(ctx.trace)) is None


def test_a_span_with_no_gap_under_it_reads_zero(telemetry):
    telemetry({"prefetch.takes": 4})
    t = _train_trace()
    t.cpu.append(_ev(30, "interaction.bwd", 2, 30, 40))  # busy throughout
    assert program_spans.idle_ms(_ctx(t), program_spans.named(
        ["interaction.bwd"])) == 0
    assert _read("prefetch_empty_share.train", _ctx(t)) == 0
    assert _read("host_tier_mb.train", _ctx(t)) is None  # never counted


def test_readers_give_none_for_an_older_program(telemetry):
    """No span and no counter of the program: every new reader gives None
    and raises nothing, but the syncs, which the runtime's own events
    give."""
    ctx = _ctx(_train_trace(program=False))
    for counts in (None, {}):
        telemetry(counts)
        got = {n: _read(n, ctx) for n in TRAIN_METRICS}
        assert got.pop("host_syncs.train") == pytest.approx(1.0)
        assert set(got.values()) == {None}, got
    serve = _ctx(ctx.trace, train=False)
    assert _read("score_copy_idle_ms.serve", serve) is None
    # nor is there anything without a traced stretch, or in a CPU trace
    for empty in (_ctx(None, traced=0),
                  _ctx(Trace(ctx.trace.cpu, [], (0, 200)))):
        assert all(_read(n, empty) is None for n in TRAIN_METRICS
                   if n != "host_tier_mb.train")


CELLS = ("kaggle-fs128.train-rowwise.zipf",
         "terabyte-mlperf.train-rowwise.zipf",
         "kaggle-fs128.serve-b16384.zipf")


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_traced_run_reports_what_a_cpu_trace_gives(name,
                                                          monkeypatch):
    """A CPU trace holds the program's spans but no device activity: of
    the new metrics only the host tier's bytes, a counter, read there (the
    CPU's ``device_prefetch`` passes batches through with no thread)."""
    from dlrm_tpu_torch.utils import telemetry

    got = {}
    profile = harness.Run.profile

    def keep(self, body):
        got["trace"] = profile(self, body)
        return got["trace"]

    monkeypatch.setattr(harness.Run, "profile", keep)
    telemetry.reset_counters()
    cell = spec.load_cell(name)
    res = harness.run_cell(cell, 2**31 + 5, 0.2, True, "cpu", tiny=True)
    counts = telemetry.counters()
    telemetry.reset_counters()
    spans = {e.name for e in got["trace"].cpu if e.annotation}
    new = {m["name"] for m in cell.per_layer} & \
        set(TRAIN_METRICS + SERVE_METRICS)
    assert new, cell.per_layer
    reported = new & set(res["metrics"])
    if cell.entry == "serve":
        assert {"score_batch.h2d", "score_batch.readback"} <= spans
        assert reported == set()
        return
    assert {"loss", "dense_apply", "sparse_update", "dedup", "autograd.bwd",
            "loss.bwd", "top_mlp.bwd", "interaction.bwd",
            "bottom_mlp.bwd"} <= spans
    if cell.config.get("tiers"):
        # the tiers' split (the tiny tables are all small: no other split)
        assert "grad_split" in spans
        assert reported == {"host_tier_mb.train"}
        steps = cell.traffic["traced_steps"]
        assert res["metrics"]["host_tier_mb.train"]["value"] == \
            pytest.approx((counts["host_tier.gather_bytes"]
                           + counts["host_tier.update_bytes"]) / 1e6 / steps)
    else:
        assert reported == set() and counts == {}
