"""Entry of the training mixes: the step that ``python -m dlrm_tpu_torch
train`` builds for the cell's flags (``run._build_step`` over
``run._train_plan``), fed from the pool through the program's
``device_prefetch``, the loss read every ``log_every`` steps as
``--log-every`` does.

Set-up draws the weights and the pool, builds the step, and drives it
through its first three steps, reading the program's state after the
first and the third (the check), then ``warmup_steps`` more.  The window
then runs the same object until ``--seconds`` have passed.
"""

from __future__ import annotations

import itertools
import math
import time
import types
from typing import List

import torch

from benchmark import check, program, spec
from benchmark.tracing import span
from benchmark import traffic as traffic_lib

CHECK_STEPS = 3


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def _distinct(pool, batches, t: int) -> torch.Tensor:
    """Table ``t``'s distinct ids over all its columns of ``batches``."""
    return torch.unique(torch.cat([
        pool.sparse[b][:, traffic_lib.table_columns([t], pool.hot)]
        .reshape(-1).to(torch.int64)
        for b in batches]))


class Snapshot:
    """What the check reads of the program: the dense leaves and the rows
    of the check batches, before and after its first steps."""

    def __init__(self, model, pool, job):
        self.model, self.job = model, job
        t_count = len(model.config.table_sizes)
        self.ids = [_distinct(pool, range(CHECK_STEPS), t)
                    for t in range(t_count)]
        self.first = [_distinct(pool, [0], t) for t in range(t_count)]
        self.rows0 = self.read_rows(self.ids)
        self.dense0 = [leaf.cpu().clone() for leaf in
                       program.dense_leaves(model.dense0, model.groups)]

    def read_rows(self, ids) -> List[torch.Tensor]:
        return [self.model.tables.read(t, i) for t, i in enumerate(ids)]

    def dense(self) -> List[torch.Tensor]:
        return [leaf.detach().cpu().clone() for leaf in
                program.dense_leaves(self.model.params, self.model.groups)]

    def grad_norms(self, v) -> List[float]:
        """The first step's gradient norms, from the state after it."""
        lr = float(torch.tensor(float(self.job["lr"]), dtype=torch.float32))
        d = self.model.config.feature_size
        opt = v.payload().get("opt") if v.uses_opt else None
        if self.job["dense_optimizer"] == "sgd":
            dense = [_norm((a - b) / lr) for a, b in
                     zip(self.dense0, self.dense())]
        else:
            dense = [math.sqrt(float(acc.double().sum())) for acc in
                     program.dense_leaves(opt["dense"], self.model.groups)]
        if self.job["sparse_optimizer"] == "sgd":
            now = self.read_rows(self.first)
            before = [r[torch.searchsorted(i, f)] for r, i, f in
                      zip(self.rows0, self.ids, self.first)]
            tables = [_norm((a - b) / lr) for a, b in zip(before, now)]
        else:
            accs = program.accumulators(self.model, opt)
            tables = [math.sqrt(d * float(accs.read(t, f).double().sum()))
                      for t, f in enumerate(self.first)]
        return dense + tables

    def change_norms(self) -> List[float]:
        dense = [_norm(a - b) for a, b in zip(self.dense(), self.dense0)]
        now = self.read_rows(self.ids)
        return dense + [_norm(a - b) for a, b in zip(now, self.rows0)]


def reference_readings(cfg: dict, dense0: dict, ids, rows0,
                       batches: List[dict], job, device, tf32: bool = False,
                       half_batch: bool = False) -> dict:
    """The reference's losses, first gradient norms and change norms over
    the check batches (tables held as the rows they touch), by the model
    that ``cfg`` names."""
    ref = spec.model(cfg)
    hot = traffic_lib.hotness(cfg["n_hot"], len(cfg["table_sizes"]))
    with ref.precision(tf32):
        rows = ref.Rows([i.to(device) for i in ids],
                        [r.to(device) for r in rows0], hot)
        params = {tw: [{k: v.to(device) for k, v in layer.items()}
                       for layer in layers] for tw, layers in dense0.items()}
        trainer = ref.Trainer(params, rows, job, half_batch=half_batch)
        losses, grads = [], None
        for b in batches:
            loss, dg, tg = trainer.step({k: v.to(device)
                                         for k, v in b.items()})
            losses.append(loss)
            if grads is None:
                grads = [_norm(g) for g in dg] + [_norm(g) for g in tg]
        change = [_norm(a - b.to(device)) for a, b in
                  zip(ref.leaves(trainer.params), ref.leaves(params))]
        change += [_norm(v - r.to(device))
                   for v, r in zip(rows.values, rows0)]
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def run(r, start: float) -> dict:
    B = r.traffic["batch"]
    job = r.traffic
    device = r.device
    t0 = time.perf_counter()
    model = program.build(r.config, r.traffic, r.seed, device, r.tiny,
                          say=r.say)
    r.sync()
    t_weights = time.perf_counter()
    pool = traffic_lib.make_pool(
        r.traffic, r.config["table_sizes"], r.config["num_dense"], r.seed,
        device, batch=B, n_batches=r.traffic["pool_batches"], pinned=True,
        n_hot=r.config["n_hot"])
    r.say(f"set-up: weights {t_weights - t0:.2f} s, pool of {len(pool)} "
          f"batches {pool.seconds:.2f} s")
    v = program.train_step(model)
    snap = Snapshot(model, pool, job)

    def source():
        for i in itertools.count():
            yield pool.batch(i)

    from dlrm_tpu_torch.data.prefetch import device_prefetch
    from dlrm_tpu_torch.train.train import batch_to_device

    feed = device_prefetch(source(), size=int(model.ns.prefetch),
                           device=device)
    steps = 0

    def step():
        nonlocal steps
        with span("bench.feed"):
            batch = next(feed)
        with span("bench.step"):
            loss, _ = v.step(batch_to_device(batch, device))
        steps += 1
        return loss

    t_check = time.perf_counter()
    prog = {"losses": []}
    for k in range(CHECK_STEPS):
        prog["losses"].append(float(step()))
        if k == 0:
            prog["grad_norms"] = snap.grad_norms(v)
    prog["change_norms"] = snap.change_norms()
    for _ in range(int(job["warmup_steps"])):
        step()
    r.sync()
    setup_s = time.perf_counter() - start
    r.say(f"set-up: check steps and warm-up {time.perf_counter() - t_check:.2f}"
          f" s; set-up {setup_s:.2f} s")

    log_every = int(model.ns.log_every)
    wait = 0.0
    first = steps
    t_start = time.perf_counter()
    while True:
        tw = time.perf_counter()
        batch = next(feed)
        wait += time.perf_counter() - tw
        loss, _ = v.step(batch_to_device(batch, device))
        steps += 1
        if steps % log_every == 0:
            float(loss)
        if time.perf_counter() - t_start >= r.seconds:
            break
    r.sync()
    window_s = time.perf_counter() - t_start
    n = steps - first
    r.say(f"window: {n} steps in {window_s:.3f} s")

    trace, traced = None, []
    if r.trace:
        k0 = steps
        count = int(job["traced_steps"])

        def body():
            for _ in range(count):
                loss = step()
                if steps % log_every == 0:
                    with span("bench.loss_read"):
                        float(loss)
        trace = r.profile(body)
        traced = [i % len(pool) for i in range(k0, k0 + count)]
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    feed.close()
    check_batches = [{"dense": pool.dense[k], "sparse": pool.sparse[k],
                      "labels": pool.labels[k]} for k in range(CHECK_STEPS)]
    device_tables = [t for t in range(len(r.config["table_sizes"]))
                     if t not in (r.config.get("tiers") or {}).get(
                         "host_tables", [])]
    ctx = types.SimpleNamespace(
        cfg=r.config, job=job, batch=B, train=True, setup_s=setup_s,
        window={"seconds": window_s, "steps": n, "examples": n * B,
                "data_wait_s": wait},
        trace=trace, traced=[pool.sparse[i] for i in traced],
        device_tables=device_tables,
        host_tables=[t for t in range(len(r.config["table_sizes"]))
                     if t not in device_tables],
        device_rows=sum(r.config["table_sizes"][t] for t in device_tables))
    dense0 = model.dense0
    del v, model, feed, snap.model
    program.free_device_memory()
    t_ref = time.perf_counter()
    want = reference_readings(r.config, dense0, snap.ids, snap.rows0,
                              check_batches, job, device)
    numbers = check.train_numbers(prog, want)
    if r.keep is not None:
        r.keep.update(dense0=dense0, ids=snap.ids, rows0=snap.rows0,
                      batches=check_batches, prog=prog, ref=want)
    r.say(f"reference: {time.perf_counter() - t_ref:.2f} s; leaves left "
          f"out of change_gap: {check.leaves_left_out(want)}; losses "
          f"{prog['losses']} against {want['losses']}")
    return {"numbers": numbers, "attempted": n, "failed": 0,
            "memory_peak_bytes": peak, "context": ctx}
