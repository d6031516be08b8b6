"""Entry of the scoring mixes: ``run.score_batch``, the scoring step of
``python -m dlrm_tpu_torch predict``, one numpy batch at a time in a
closed loop, the scores back on the host.

Set-up draws the weights and the pool, picks ``check_batches`` pool batches
from the seed and copies their rows and the dense weights aside for the
reference, and scores ``warmup_batches``.  The window cycles through the
pool until ``--seconds`` have passed, timing each batch host to host and
keeping every score it served for a picked batch; the reference then
scores those batches and every kept answer is compared.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from benchmark import check, program, spec
from benchmark import traffic as traffic_lib
from benchmark.tracing import span


def picked_batches(seed: int, n_pool: int, k: int):
    rng = np.random.default_rng(traffic_lib.stream_seed(seed, 5))
    return sorted(int(i) for i in rng.choice(n_pool, size=k, replace=False))


def run(r, start: float) -> dict:
    B = r.traffic["batch"]
    device = r.device
    t0 = time.perf_counter()
    model = program.build(r.config, r.traffic, r.seed, device, r.tiny,
                          say=r.say)
    r.sync()
    t_weights = time.perf_counter()
    pool = traffic_lib.make_pool(
        r.traffic, r.config["table_sizes"], r.config["num_dense"], r.seed,
        device, batch=B, n_batches=r.traffic["pool_batches"], pinned=False,
        n_hot=r.config["n_hot"])
    picked = picked_batches(r.seed, len(pool), int(r.traffic["check_batches"]))
    t_count = len(r.config["table_sizes"])
    # each table's rows of each of its columns: (B, sum H, D)
    rows = {i: torch.cat([model.tables.read(
        t, pool.sparse[i][:, traffic_lib.table_columns([t], pool.hot)]
        .reshape(-1)).view(B, pool.hot[t], -1) for t in range(t_count)],
        dim=1) for i in picked}
    r.say(f"set-up: weights {t_weights - t0:.2f} s, pool of {len(pool)} "
          f"batches {pool.seconds:.2f} s, {len(picked)} batches picked for "
          f"the check")
    for i in range(int(r.traffic["warmup_batches"])):
        program.score_batch(model, pool.numpy_batch(i), device)
    r.sync()
    setup_s = time.perf_counter() - start
    r.say(f"set-up {setup_s:.2f} s")

    kept = {i: [] for i in picked}
    batch_s = []
    failed = 0
    n = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < r.seconds:
        i = n % len(pool)
        b = pool.numpy_batch(i)
        ta = time.perf_counter()
        scores = program.score_batch(model, b, device)
        batch_s.append(time.perf_counter() - ta)
        n += 1
        if scores.shape != (B,) or not np.isfinite(scores).all():
            failed += 1
        if i in kept:
            kept[i].append(np.array(scores, copy=True))
    window_s = time.perf_counter() - t_start
    r.say(f"window: {n} batches in {window_s:.3f} s")

    trace, traced = None, []
    if r.trace:
        k0, count = n, int(r.traffic["traced_batches"])

        def body():
            for j in range(k0, k0 + count):
                with span("bench.score_batch"):
                    program.score_batch(model, pool.numpy_batch(j), device)
        trace = r.profile(body)
        traced = [j % len(pool) for j in range(k0, k0 + count)]
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    device_tables = [t for t in range(t_count)
                     if t not in (r.config.get("tiers") or {}).get(
                         "host_tables", [])]
    ctx = types.SimpleNamespace(
        cfg=r.config, job=r.traffic, batch=B, train=False, setup_s=setup_s,
        window={"seconds": window_s, "steps": n, "examples": n * B,
                "batch_s": batch_s, "data_wait_s": None},
        trace=trace, traced=[pool.sparse[j] for j in traced],
        device_tables=device_tables,
        host_tables=[t for t in range(t_count) if t not in device_tables],
        device_rows=sum(r.config["table_sizes"][t] for t in device_tables))
    dense0 = model.dense0
    del model
    program.free_device_memory()
    t_ref = time.perf_counter()
    ref = spec.model(r.config)
    pairs = []
    with ref.precision(False):
        params = {tw: [{k: v.to(device) for k, v in layer.items()}
                       for layer in layers] for tw, layers in dense0.items()}
        for i in picked:
            want = ref.score(params, ref.pool(rows[i].to(device), pool.hot),
                             pool.dense[i].to(device)).cpu()
            pairs += [(torch.from_numpy(got), want) for got in kept[i]]
    numbers = check.serve_numbers(pairs)
    if r.keep is not None:
        r.keep.update(dense0=dense0, rows=rows, hot=pool.hot,
                      picked=picked, pairs=pairs,
                      dense={i: pool.dense[i] for i in picked})
    r.say(f"reference: {time.perf_counter() - t_ref:.2f} s, "
          f"{len(pairs)} answers of {len(picked)} batches compared")
    return {"numbers": numbers, "attempted": n, "failed": failed,
            "memory_peak_bytes": peak, "context": ctx}
