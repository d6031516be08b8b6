"""The reader of the dense optimizer's launch counter
(``benchmark/metrics/dense_apply_launches.train.py``): a traced step's
launches from the program's counter ``dense_apply.launches``; None where the
program has no such counter (an older program), in a scoring run and
without a traced stretch; and a tiny CPU run of each training cell with
``--trace 1``, where nothing is launched on a card and the line leaves the
metric out."""

import sys
import types

import pytest

from benchmark import harness, program_spans, spec

NAME = "dense_apply_launches.train"
TRAIN_CELLS = ("kaggle-fs128.train-rowwise.zipf",
               "terabyte-mlperf.train-rowwise.zipf")


def _read(ctx):
    return spec.load_module("metrics", NAME).read(ctx)


def _ctx(train=True, traced=4):
    return types.SimpleNamespace(trace=object(), traced=[None] * traced,
                                 train=train)


@pytest.fixture
def telemetry(monkeypatch):
    """The program's telemetry module as the reader finds it, with the
    counters given (None: a module without counters)."""
    def put(counts):
        mod = types.ModuleType(program_spans.TELEMETRY)
        if counts is not None:
            mod.counters = lambda: dict(counts)
        monkeypatch.setitem(sys.modules, program_spans.TELEMETRY, mod)
    return put


@pytest.mark.parametrize("launches,want", [
    (4, 1.0),       # the multi-tensor kernel: one launch a step
    (640, 160.0),   # the per-leaf loop: ten a leaf of the 16
])
def test_reads_the_launches_a_traced_step(telemetry, launches, want):
    telemetry({"dense_apply.launches": launches,
               "host_tier.gather_bytes": 7})
    assert _read(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("counts,ctx", [
    ({"prefetch.takes": 4}, _ctx()),                    # never counted
    (None, _ctx()),                                     # no counters at all
    ({"dense_apply.launches": 4}, _ctx(train=False)),   # a scoring run
    ({"dense_apply.launches": 4}, _ctx(traced=0)),      # no traced stretch
])
def test_reads_none_where_there_is_nothing_to_read(telemetry, counts, ctx):
    telemetry(counts)
    assert _read(ctx) is None


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_a_tiny_traced_cpu_run_leaves_the_metric_out(name):
    """The cells report the metric (``BENCHMARK.json``), and a CPU run,
    whose optimizer launches nothing on a card, leaves it out of its line
    without raising."""
    from dlrm_tpu_torch.utils import telemetry

    cell = spec.load_cell(name)
    assert NAME in {m["name"] for m in cell.per_layer}
    telemetry.reset_counters()
    try:
        res = harness.run_cell(cell, 2**31 + 9, 0.2, True, "cpu", tiny=True)
        assert "dense_apply.launches" not in telemetry.counters()
    finally:
        telemetry.reset_counters()
    assert NAME not in res["metrics"]
