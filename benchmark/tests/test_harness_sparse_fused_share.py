"""The reader of the sorted segment sum's share
(``benchmark/metrics/sparse_fused_share.train.py``): a traced stretch's
``sparse_update.fused_hits`` over ``sparse_update.hits``, %; None where the
program counts no hits (an older program, no counters at all, no hit
counted), in a scoring run and without a traced stretch; and a tiny CPU run
of each training cell with ``--trace 1``, where nothing reaches a card and
the line leaves the metric out."""

import sys
import types

import pytest

from benchmark import harness, program_spans, spec

NAME = "sparse_fused_share.train"
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


@pytest.mark.parametrize("counts,want", [
    # every device hit through the kernel (the all-device row-wise step)
    ({"sparse_update.hits": 3407872, "sparse_update.fused_hits": 3407872},
     100.0),
    # today's split, dedup and apply: hits counted, none fused
    ({"sparse_update.hits": 3407872}, 0.0),
    ({"sparse_update.hits": 400, "sparse_update.fused_hits": 100,
      "prefetch.takes": 4}, 25.0),
])
def test_reads_the_counters_share(telemetry, counts, want):
    telemetry(counts)
    assert _read(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("counts,ctx", [
    ({"prefetch.takes": 4}, _ctx()),                    # no hit counted
    ({"sparse_update.hits": 0}, _ctx()),                # no hits
    (None, _ctx()),                                     # no counters at all
    ({"sparse_update.hits": 8,
      "sparse_update.fused_hits": 8}, _ctx(train=False)),  # a scoring run
    ({"sparse_update.hits": 8,
      "sparse_update.fused_hits": 8}, _ctx(traced=0)),     # no traced stretch
])
def test_reads_none_where_there_is_nothing_to_read(telemetry, counts, ctx):
    telemetry(counts)
    assert _read(ctx) is None


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_a_tiny_traced_cpu_run_leaves_the_metric_out(name):
    """The training cells report the metric (``BENCHMARK.json``), and a CPU
    run, whose hits reach no card, leaves it out of its line without
    raising."""
    from dlrm_tpu_torch.utils import telemetry

    cell = spec.load_cell(name)
    assert NAME in {m["name"] for m in cell.per_layer}
    telemetry.reset_counters()
    try:
        res = harness.run_cell(cell, 2**31 + 11, 0.2, True, "cpu", tiny=True)
        assert "sparse_update.hits" not in telemetry.counters()
    finally:
        telemetry.reset_counters()
    assert NAME not in res["metrics"]
