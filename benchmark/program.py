"""The benchmark's only door into the program under test, ``dlrm_tpu_torch``:
the CLI's own flags and builders (``run.build_parser``, ``run._build_config``,
``run._train_plan``, ``run._build_step``, ``run.score_batch``), the tier plan
of ``--hbm-budget-gb`` and the program's storage for it.

The weights are the benchmark's: drawn here from ``--seed`` on the device
into the program's storage, so the reference can be given the same values
without taking anything the program made.  The dense leaves, their laws and
the sizes held against the program are the configuration's model's
(``reference/__init__.py``).  ``TableStore`` says where each
table's rows lie in that storage, for the snapshots of the check.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchmark import spec
from benchmark import traffic as traffic_lib

GIB = 1 << 30
STAGING_ROWS = 1 << 22


def tiny(config: dict, traffic: dict) -> Tuple[dict, dict]:
    """The CPU dry path's sizes: widths kept, each table cut to
    ``64 + (n - 64) // 100000`` rows (order kept, so a tier plan splits
    the same tables), batches of 64, a pool of 4 batches."""
    sizes = [n if n <= 64 else 64 + (n - 64) // 100_000
             for n in config["table_sizes"]]
    cfg = {**config, "table_sizes": sizes}
    mix = {**traffic, "batch": 64, "pool_batches": 4}
    return cfg, mix


def table_size_flag(sizes: Sequence[int]) -> List[str]:
    return ["--table-sizes", ",".join(str(int(n)) for n in sizes)]


def cli(config: dict, traffic: dict, tiny_run: bool) -> List[str]:
    """The ``train`` flags of this cell: the configuration's preset flags,
    the job's, the batch; the tables' sizes spelled out when cut."""
    args = ["train", *config["program_args"], *traffic.get("program_args", []),
            "--batch-size", str(traffic["batch"]), "--steps", "1000000000"]
    if tiny_run:
        args += table_size_flag(config["table_sizes"])
    return args


def parse(args: List[str]) -> argparse.Namespace:
    from dlrm_tpu_torch import run
    return run.build_parser().parse_args(args)


def program_config(ns: argparse.Namespace, config: dict, device):
    """The program's ``DLRMConfig`` for these flags, held to the
    configuration file: a preset that drifted from the published sizes
    fails here, before any run."""
    from dlrm_tpu_torch import run

    c = run._build_config(ns, torch.device(device))
    keys = spec.model(config).PROGRAM_KEYS
    got = {k: getattr(c, attr, None) for k, attr in keys.items()}
    got = {k: list(v) if isinstance(v, tuple) else v for k, v in got.items()}
    want = {k: config[k] for k in keys}
    got["dtype"] = str(c.embedding_dtype).removeprefix("torch.")
    got["compute_dtype"] = str(c.compute_dtype).removeprefix("torch.")
    want["dtype"] = want["compute_dtype"] = config["dtype"]
    if "n_hot" in keys:
        # one hotness for every table, as an int or a list, is one
        # configuration: held table by table
        t = len(config["table_sizes"])
        if traffic_lib.hotness(got["n_hot"], t) == \
                traffic_lib.hotness(want["n_hot"], t):
            got["n_hot"] = want["n_hot"]
    if got != want:
        diff = "; ".join(f"{k}: the program's {got[k]!r}, the "
                         f"configuration's {want[k]!r}"
                         for k in want if got[k] != want[k])
        raise SystemExit(f"the program's model differs from the "
                         f"configuration file: {diff}")
    return c


@dataclasses.dataclass
class TableStore:
    """Where table ``t`` lies: ``(tensor, first row)`` per table."""

    places: List[Tuple[torch.Tensor, int]]

    def read(self, t: int, rows: torch.Tensor) -> torch.Tensor:
        """The rows (int64, per-table ids) of table ``t``, on the host,
        after every queued kernel (host storage is written by the card)."""
        tensor, lo = self.places[t]
        if tensor.device.type == "cpu" and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        idx = rows.to(tensor.device, torch.int64) + lo
        return tensor.index_select(0, idx).float().cpu()


def _store(tensors: Dict[str, torch.Tensor], plan, sizes: Sequence[int]
           ) -> TableStore:
    """A store over one stacked tensor (``plan`` None) or over the device
    and host tiers of a tier plan."""
    if plan is None:
        places, off = [], 0
        for n in sizes:
            places.append((tensors["all"], off))
            off += n
        return TableStore(places)
    places = [None] * len(sizes)
    for key, tables, offs in (("dev", plan.device_tables, plan.device_offsets),
                              ("host", plan.host_tables, plan.host_offsets)):
        for t, lo in zip(tables, offs):
            places[t] = (tensors[key], lo)
    return TableStore(places)


def wait_for_host_memory(need: int, timeout: float = 120.0,
                         say=print) -> float:
    """Wait, at most ``timeout`` s, until MemAvailable covers ``need``
    bytes (memory freed by a process that just ended comes back late);
    returns the seconds waited."""
    t0 = time.perf_counter()
    while True:
        avail = None
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        avail = int(line.split()[1]) * 1024
        except OSError:
            return 0.0
        waited = time.perf_counter() - t0
        if avail is None or avail >= need or waited >= timeout:
            say(f"host memory: {0 if avail is None else avail / 1e9:.2f} GB "
                f"available for {need / 1e9:.2f} GB after {waited:.2f} s")
            return waited
        time.sleep(0.5)


@dataclasses.dataclass
class Model:
    ns: argparse.Namespace      # the train flags
    config: object              # the program's DLRMConfig
    params: dict                # in the program's layout
    tables: TableStore
    groups: list                # the model's dense_groups
    plan: object = None         # the tier plan, or None
    dense0: Optional[dict] = None


def draw_dense(gen: torch.Generator, config: dict, device) -> dict:
    """The model's dense leaves (``dense_groups``), each ``randn(shape) *
    std`` in f32 on ``device``, in draw order: ``{group: [{key: leaf}]}``."""
    return {group: [{k: torch.randn(shape, generator=gen, device=device,
                                    dtype=torch.float32) * std
                     for k, (shape, std) in layer.items()}
                    for layer in layers]
            for group, layers in spec.model(config).dense_groups(config)}


def fill_tables(gen: torch.Generator, store: TableStore, sizes: Sequence[int],
                device) -> None:
    """Table ``t`` ~ U(-1/sqrt(n_t), 1/sqrt(n_t)), drawn on ``device``: in
    place for device storage, through one staging buffer for host
    storage."""
    device = torch.device(device)
    staging = None
    for t, n in enumerate(sizes):
        tensor, lo = store.places[t]
        dst = tensor[lo:lo + n]
        bound = 1.0 / math.sqrt(n)
        if tensor.device.type == device.type:
            dst.uniform_(-bound, bound, generator=gen)
            continue
        for a in range(0, n, STAGING_ROWS):
            part = dst[a:a + STAGING_ROWS]
            if staging is None:
                staging = torch.empty((STAGING_ROWS, dst.shape[1]),
                                      dtype=dst.dtype, device=device)
            buf = staging[:part.shape[0]]
            buf.uniform_(-bound, bound, generator=gen)
            part.copy_(buf, non_blocking=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(config: dict, traffic: dict, seed: int, device, tiny_run: bool,
          say=print) -> Model:
    """The program's parameters for this cell, drawn from ``seed``."""
    from dlrm_tpu_torch.parallel import host_tier as ht

    device = torch.device(device)
    ns = parse(cli(config, traffic, tiny_run))
    tiers = config.get("tiers")
    sizes = config["table_sizes"]
    d = config["feature_size"]
    plan = None
    if tiers:
        host_tables = list(tiers["host_tables"])
        budget = tiers["hbm_budget_gb"]
        if tiny_run:
            dev_bytes = sum(n for t, n in enumerate(sizes)
                            if t not in host_tables) * d * 4
            budget = (dev_bytes + d * 2) / GIB
        ns.hbm_budget_gb = budget
    c = program_config(ns, config, device)
    gen = torch.Generator(device).manual_seed(traffic_lib.stream_seed(seed, 0))
    dense = draw_dense(gen, config, device)
    dense0 = {group: [{k: v.cpu().clone() for k, v in layer.items()}
                      for layer in layers] for group, layers in dense.items()}
    if tiers:
        plan = ht.plan_tiers(c, int(ns.hbm_budget_gb * GIB))
        if list(plan.host_tables) != host_tables:
            raise SystemExit(f"the tier plan of --hbm-budget-gb "
                             f"{ns.hbm_budget_gb} puts tables "
                             f"{list(plan.host_tables)} on the host; the "
                             f"configuration states {host_tables}")
        if device.type == "cuda":
            need = plan.host_rows * (d + 1) * 4 + traffic_bytes(traffic, config)
            wait_for_host_memory(need + 8 * 10**9, say=say)
        dev = torch.empty((plan.device_rows, d), dtype=torch.float32,
                          device=device)
        host = ht._host_empty((plan.host_rows, d), torch.float32, device)
        emb = ht.TieredEmb(dev, host, plan)
        store = _store({"dev": dev, "host": host}, plan, sizes)
    else:
        emb = torch.empty((sum(sizes), d), dtype=torch.float32, device=device)
        store = _store({"all": emb}, None, sizes)
    fill_tables(gen, store, sizes, device)
    params = {**dense, "emb": emb}
    groups = spec.model(config).dense_groups(config)
    return Model(ns=ns, config=c, params=params, tables=store, groups=groups,
                 plan=plan, dense0=dense0)


def traffic_bytes(traffic: dict, config: dict) -> int:
    """The pool's bytes: dense features, an id a lookup, a label."""
    ids = sum(traffic_lib.hotness(config["n_hot"],
                                  len(config["table_sizes"])))
    return traffic["pool_batches"] * traffic["batch"] * (
        config["num_dense"] * 4 + ids * 4 + 4)


def accumulators(model: Model, opt: dict) -> Optional[TableStore]:
    """The program's row-wise accumulators of the tables, laid out as the
    tables are (one scalar a row), or None."""
    if model.plan is None:
        acc = opt.get("emb")
        if acc is None:
            return None
        return _store({"all": acc.view(-1, 1) if acc.dim() == 1 else acc},
                      None, model.config.table_sizes)
    dev, host = opt.get("dev_acc"), opt.get("host_acc")
    if dev is None and host is None:
        return None
    return _store({"dev": dev.view(-1, 1), "host": host.view(-1, 1)},
                  model.plan, model.config.table_sizes)


def train_step(model: Model):
    """The step that ``train`` builds for these flags:
    ``run._build_step`` over ``run._train_plan``."""
    from dlrm_tpu_torch import run

    return run._build_step(model.ns, model.config, run._train_plan(model.ns),
                           model.params)


def score_batch(model: Model, batch, device):
    from dlrm_tpu_torch import run

    return run.score_batch(model.params, batch, model.config, device)


def dense_leaves(params: dict, groups) -> List[torch.Tensor]:
    """The dense leaves of ``params`` (or of a tree laid out like them, as
    the optimizer's state) in the draw order of ``groups``, the model's
    ``dense_groups``."""
    return [params[group][i][k] for group, layers in groups
            for i, layer in enumerate(layers) for k in layer]


def free_device_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
