"""The idle share from the union of device intervals, not from summed
self times, and idle gaps named by the host span open at the time, on a
trace built by hand."""

import types

import pytest

from benchmark import readers, tracing
from benchmark.tracing import CpuEvent, DeviceEvent, Trace


def _trace():
    # window 0-100 us; the compute stream runs 10-40 and 60-90; a copy on
    # the prefetch stream runs 30-50, under the first kernel's end
    cpu = [
        CpuEvent(1, "bench.traced", 1, 0, 100, None, [], True),
        CpuEvent(2, "bench.step", 1, 0, 95, 1, [], True),
        CpuEvent(3, "aten::mm", 1, 5, 8, 2, [[32768, 479], [479, 1024]],
                 False, 30e-6),
        CpuEvent(4, "host_tier_update", 1, 50, 58, 2, [], True),
        CpuEvent(5, "aten::unique", 1, 51, 57, 4, [[65536]], False),
        CpuEvent(6, "aten::index_add_", 1, 58, 59, 2,
                 [[1000, 128], [], [10], [10, 128]], False),
        CpuEvent(8, "cudaLaunchKernel", 1, 58.5, 58.9, 6, [], False, 30e-6),
        CpuEvent(7, "aten::copy_", 2, 29, 31, None, [], False, 20e-6),
    ]
    dev = [
        DeviceEvent("sm90_xmma_gemm_f32f32", 10, 40),
        DeviceEvent("Memcpy HtoD (Pinned -> Device)", 30, 50),
        DeviceEvent("indexFuncLargeIndex", 60, 90),
    ]
    return Trace(cpu, dev, (0, 100))


def test_idle_from_the_union_of_intervals():
    t = _trace()
    assert tracing.busy_s(t) == pytest.approx(70e-6)
    # summed self times, as chip_smoke._profile_steps takes them, count
    # the copy under the kernel twice
    assert sum(d.end - d.start for d in t.device) / 1e6 == \
        pytest.approx(80e-6)
    assert t.window_s == pytest.approx(100e-6)
    # 30% idle by the union; summed self times would say 20%
    assert 1 - tracing.busy_s(t) / t.window_s == pytest.approx(0.3)


def test_idle_share_takes_the_time_a_step_from_the_untraced_window():
    # two traced steps keep the device busy 70 us; the untraced window ran
    # 10 steps in 500 us: 35 us busy of 50 a step, whatever the traced
    # stretch's own length (100 us, slowed by the profiler)
    ctx = types.SimpleNamespace(trace=_trace(), traced=[0, 1],
                                window={"seconds": 500e-6, "steps": 10})
    assert readers.idle_share(ctx) == pytest.approx(30.0)
    ctx.window = {"seconds": 1000e-6, "steps": 10}
    assert readers.idle_share(ctx) == pytest.approx(65.0)
    ctx.traced = []
    assert readers.idle_share(ctx) is None


def test_gaps_are_named_by_the_host_span_open():
    t = _trace()
    assert tracing.idle_gaps(t) == [(0, 10), (50, 60), (90, 100)]
    names = tracing.gap_names(t, tracing.idle_gaps(t))
    assert names[0] == "bench.step: aten::mm"
    assert names[1] == "host_tier_update: aten::unique"
    assert names[2] == "bench.step: no operation"
    by = tracing.idle_by_span(t)
    assert by["host_tier_update: aten::unique"] == pytest.approx(10e-6)


def test_groups_and_launching_operations():
    t = _trace()
    g = tracing.device_groups(t)
    assert g["MLP GEMMs (gemm, gemv, split-K reduce)"] == pytest.approx(30e-6)
    assert g["host-to-device copies"] == pytest.approx(20e-6)
    upd = tracing.op_seconds(t, ("aten::index_add_",),
                             lambda s: s[0] == 1000)
    assert upd == pytest.approx(30e-6)
    assert tracing.op_seconds(t, ("aten::index_add_",),
                              lambda s: s[0] == 999) == 0
    b = tracing.breakdown(t)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
