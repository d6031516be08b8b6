"""A model enters the benchmark as files alone: the configuration's
``model`` picks its reference module, which gives the dense leaves and the
counts; multi-hot ids, at one hotness for every table or one a table,
reach the traffic, the counts, the entries and the reference; a
configuration whose hotness the program cannot take stops before any
draw; and the three cells' pools, weights and counts stay as they were
before either existed."""

import ast
import dataclasses
import hashlib
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import counts, program, readers, spec, traffic
from benchmark.reference import dlrm as ref

ROOT = Path(__file__).resolve().parents[2]
TRAIN = "kaggle-fs128.train-rowwise.zipf"
TIERED = "terabyte-mlperf.train-rowwise.zipf"
SERVE = "kaggle-fs128.serve-b16384.zipf"
CELLS = (TRAIN, TIERED, SERVE)
# the dry path's limits (test_harness_control's)
TINY = {"loss_gap": 1e-5, "grad_gap": 5e-4, "change_gap": 5e-4,
        "score_gap": 1e-5}


def _copy_with(tmp: Path, configs: dict, cells: dict,
               references: dict = None) -> Path:
    """A copy of the benchmark with more configurations (name: file), more
    cells (name: (configuration, mix, like)) reporting the metrics of the
    cell ``like``, and more reference modules (name: source), made of new
    files and new entries alone."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in configs.items():
        (tmp / f"benchmark/configs/{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "a test"})
    for name, src in (references or {}).items():
        (tmp / f"benchmark/reference/{name}.py").write_text(src)
    for name, (config, mix, like) in cells.items():
        limits = {k: TINY[k] for k in spec.load_cell(like).limits}
        (tmp / f"benchmark/cells/{name}.json").write_text(
            json.dumps({"limits": limits}))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def _config(name: str) -> dict:
    return json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())


# the subprocess: run each cell tiny, seed 7, traced, and read the table
# and host-tier rooflines over a stand-in second of device time (a CPU run
# has no device events), from the entry's own context
RUN = """
import json, sys
sys.path[:0] = [{root!r}, {repo!r}]
from benchmark import harness, readers, spec, tracing
real, ctxs = spec.load_module, []

def load(kind, name):
    mod = real(kind, name)
    if kind == "entries":
        run = mod.run
        def keep(r, start):
            out = run(r, start)
            ctxs.append(out["context"])
            return out
        mod.run = keep
    return mod

spec.load_module = load
tracing.op_seconds = lambda *a: 1.0
readers.named_seconds = lambda *a: 1.0
for name in {names!r}:
    res = harness.run_cell(spec.load_cell(name), 7, 0.3, True, "cpu",
                           tiny=True)
    ctx = ctxs[-1]
    res["rooflines"] = {{"embedding": readers.embedding(ctx),
                         "host_tier": readers.host_tier(ctx)}}
    res["id_columns"] = int(ctx.traced[0].shape[1])
    print(json.dumps(res))
"""


def _run(root: Path, names) -> list:
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(root), repo=str(ROOT),
                                          names=list(names))],
        capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.strip().splitlines()
            if line.startswith("{")]


def test_uniform_hotness_runs_through_the_port_on_one_tier_and_two(tmp_path):
    """``n_hot: 3`` with ``--n-hot 3``: the program takes (B, T, 3) ids,
    and the entries, counts and reference read the 78 columns.  ``n_hot:
    [3] * 26`` is the same configuration: the same numbers and
    rooflines."""
    configs, cells = {}, {}
    for base, like in (("kaggle-fs128", TRAIN), ("terabyte-mlperf", TIERED)):
        for name, hot in ((f"{base}-hot3", 3), (f"{base}-hot3list", [3] * 26)):
            cfg = _config(base)
            cfg.update(name=name, n_hot=hot,
                       program_args=cfg["program_args"] + ["--n-hot", "3"])
            configs[name] = cfg
            cells[f"{name}.train-rowwise.zipf"] = (
                name, "train-rowwise.zipf", like)
    cells["kaggle-fs128-hot3.serve-b16384.zipf"] = (
        "kaggle-fs128-hot3", "serve-b16384.zipf", SERVE)
    root = _copy_with(tmp_path, configs, cells)
    results = dict(zip(cells, _run(root, list(cells))))
    for name, res in results.items():
        assert res["correct"] is True, (name, res["checks"])
        assert res["id_columns"] == 78
        emb = res["rooflines"]["embedding"]
        assert emb is not None and math.isfinite(emb) and emb > 0, name
    for base in ("kaggle-fs128", "terabyte-mlperf"):
        a, b = (results[f"{base}-hot3{tag}.train-rowwise.zipf"]
                for tag in ("", "list"))
        assert a["checks"] == b["checks"], base
        assert a["rooflines"] == b["rooflines"], base
    for tag in ("", "list"):
        host = results[f"terabyte-mlperf-hot3{tag}.train-rowwise.zipf"][
            "rooflines"]["host_tier"]
        assert host is not None and math.isfinite(host) and host > 0
    assert results["kaggle-fs128-hot3.train-rowwise.zipf"][
        "rooflines"]["host_tier"] is None


PLANT = ("    return _mlp(dense_params[\"top\"], interact(x, pooled), "
         "\"sigmoid\")[:, 0]\n")


@pytest.mark.parametrize("planted", [False, True])
def test_a_model_named_by_its_configuration_decides_correct(tmp_path,
                                                             planted):
    """A reference module added as a file is loaded by the configuration's
    ``model``: a copy of ``dlrm`` reads correct, the same copy with a ReLU
    on the top MLP's input does not, in training and in scoring."""
    src = (ROOT / "benchmark/reference/dlrm.py").read_text()
    assert src.count(PLANT) == 1
    if planted:
        src = src.replace(PLANT, PLANT.replace(
            "interact(x, pooled)", "torch.relu(interact(x, pooled))"))
    cfg = _config("kaggle-fs128")
    cfg.update(name="kaggle-fs128-other", model="other_dlrm")
    cells = {"kaggle-fs128-other.train-rowwise.zipf": (
                 "kaggle-fs128-other", "train-rowwise.zipf", TRAIN),
             "kaggle-fs128-other.serve-b16384.zipf": (
                 "kaggle-fs128-other", "serve-b16384.zipf", SERVE)}
    root = _copy_with(tmp_path, {"kaggle-fs128-other": cfg}, cells,
                      {"other_dlrm": src})
    for res in _run(root, list(cells)):
        assert res["correct"] is (not planted), res["checks"]


def _sha(t: torch.Tensor) -> str:
    t = t.detach().contiguous()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()
                          ).hexdigest()[:16]


# the tiny pool (dense, sparse, labels), the dense weights and the weight
# generator's next draw of each cell at seed 7, as the harness drew them
# before models were named by their configurations
PINNED = {
    TRAIN: (["23492195403dd753", "8f17618efeec1532", "198eb7ca96cd3d87"],
            "01c08a8f403fc8e2", "57c82e637ff3fa4e"),
    TIERED: (["23492195403dd753", "4ac6ae1de4ddfc6b", "c2fbdf94d9efca03"],
             "01c08a8f403fc8e2", "57c82e637ff3fa4e"),
    SERVE: (["23492195403dd753", "8f17618efeec1532", "198eb7ca96cd3d87"],
            "01c08a8f403fc8e2", "57c82e637ff3fa4e"),
}


@pytest.mark.parametrize("name", CELLS)
def test_one_hot_pools_and_weights_keep_their_bits(name):
    cell = spec.load_cell(name)
    cfg, mix = program.tiny(cell.config, cell.traffic)
    pool = traffic.make_pool(mix, cfg["table_sizes"], cfg["num_dense"], 7,
                             "cpu", batch=mix["batch"],
                             n_batches=mix["pool_batches"], pinned=False,
                             n_hot=cfg["n_hot"])
    g = torch.Generator().manual_seed(traffic.stream_seed(7, 0))
    dense = program.draw_dense(g, cfg, "cpu")
    leaves = program.dense_leaves(dense, spec.model(cfg).dense_groups(cfg))
    want_pool, want_dense, want_next = PINNED[name]
    assert [_sha(pool.dense), _sha(pool.sparse), _sha(pool.labels)] == \
        want_pool
    assert _sha(torch.cat([x.reshape(-1) for x in leaves])) == want_dense
    assert _sha(torch.rand(8, generator=g)) == want_next
    assert pool.batch(1)["sparse"].shape == (mix["batch"], 26)


# each cell's counts at its full widths and batch, and for the ids of one
# batch of 512 at its full table sizes (seed 7), as before
PINNED_COUNTS = {
    TRAIN: ("803b11dfc8e434d6", 473847300096.0, 0.006991491194268656,
            0.00044314073791044777, 13529520, None),
    TIERED: ("6ff8f3a47e268b1f", 473847300096.0, 0.006991491194268656,
             0.00044314073791044777, 12877296, 3.595875e-06),
    SERVE: ("803b11dfc8e434d6", 78974550016.0, 0.0011686775059104476,
            7.698034626865672e-05, 8521216, None),
}


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_counts_keep_their_values(name):
    cell = spec.load_cell(name)
    cfg, job = cell.config, cell.traffic
    ids = traffic.make_pool(job, cfg["table_sizes"], cfg["num_dense"], 7,
                            "cpu", batch=512, n_batches=1, pinned=False,
                            n_hot=cfg["n_hot"]).sparse[0]
    train, b = cell.entry == "train", job["batch"]
    host = (cfg.get("tiers") or {}).get("host_tables", [])
    dev = [t for t in range(26) if t not in host]
    sha, flops, gemm, inter, table, tier = PINNED_COUNTS[name]
    assert _sha(ids) == sha
    assert counts.model_flops(cfg, b, train) == flops
    assert counts.gemm_bound_s(cfg, b, train) == gemm
    assert counts.interaction_bound_s(cfg, b, train) == inter
    assert counts.table_bytes(cfg, job, 512, ids, dev, train) == table
    got = counts.host_tier_bound_s(cfg, job, ids, host, train) if host \
        else None
    assert got == tier


def test_the_dlrm_module_gives_what_the_harness_reads():
    cfg = _config("kaggle-fs128")
    mod = spec.model(cfg)
    assert [g for g, _ in mod.dense_groups(cfg)] == ["bottom", "top"]
    assert set(mod.PROGRAM_KEYS) <= set(cfg)
    assert mod.forward_macs(cfg) == 2_410_112
    # the top tower's first layer takes the bottom output and 351 pairs
    assert mod.dense_groups(cfg)[1][1][0]["w"][0] == (479, 1024)


def test_multi_hot_ids_follow_mlperfs_uniform_law():
    """Each table's one-hot id first, then two more that are a fixed
    function of (table, id, slot), uniform over the table's rows; the dense
    features, one-hot ids and labels are the one-hot pool's."""
    sizes = [10**6] + [10**5 + 37 * t for t in range(25)]
    mix = {"ids": {"law": "zipf", "a": 1.2}}
    seed = 2**33 + 3
    kw = dict(batch=4096, n_batches=2, pinned=False)
    one = traffic.make_pool(mix, sizes, 13, seed, "cpu", **kw)
    pool = traffic.make_pool(mix, sizes, 13, seed, "cpu", n_hot=3, **kw)
    assert pool.sparse.shape == (2, 4096, 78)
    assert pool.batch(0)["sparse"].shape == (4096, 26, 3)
    assert torch.equal(pool.batch(0)["sparse"].reshape(4096, 78),
                       pool.sparse[0])
    assert torch.equal(pool.dense, one.dense)
    assert torch.equal(pool.labels, one.labels)
    ids = pool.sparse.reshape(-1, 26, 3).long()
    assert torch.equal(ids[:, :, 0], one.sparse.reshape(-1, 26).long())
    for t, n in enumerate(sizes):
        assert int(ids[:, t].min()) >= 0 and int(ids[:, t].max()) < n
        # the same id brings the same two more, wherever it is drawn
        key = ids[:, t, 0]
        first = torch.unique(key, return_inverse=True)[1]
        rep = torch.zeros(int(first.max()) + 1, 2, dtype=torch.long)
        rep[first] = ids[:, t, 1:]
        assert torch.equal(rep[first], ids[:, t, 1:]), t
    # the extra ids of distinct one-hot ids spread over the whole table
    key = torch.unique(ids[:, 0, 0])
    x = traffic.multi_hot(key[:, None], torch.tensor([sizes[0]]), seed, 3)
    low = (x[:, 1:] < sizes[0] // 2).double().mean()
    assert abs(float(low) - 0.5) < 0.05, float(low)
    assert torch.unique(x[:, 1:]).numel() > 0.99 * 2 * key.numel()
    assert traffic.hotness(3, 26) == traffic.hotness([3] * 26, 26) == [3] * 26
    for bad in ([3] * 25, [3] * 25 + [0], [3.0] * 26, 0, 1.0, True):
        with pytest.raises(ValueError):
            traffic.hotness(bad, 26)


def test_multi_hot_counts_every_column():
    ids = torch.tensor([[0, 0, 1, 1, 4, 9],
                        [2, 0, 0, 1, 5, 9]], dtype=torch.int32)
    cfg = {"feature_size": 4, "n_hot": 2, "table_sizes": [3, 2, 10]}
    # table 0: {0, 2}; table 1: {0, 1}; table 2: {4, 5, 9}
    assert traffic.table_columns([0, 2], [2, 2, 2]) == [0, 1, 4, 5]
    assert counts.distinct_rows(ids, [0, 1, 2], [2, 2, 2]) == 7
    assert counts.distinct_rows(ids, [2], [2, 2, 2]) == 3
    row = 16
    serve = counts.table_bytes(cfg, {}, 2, ids, [0, 2], False)
    assert serve == 5 * row + 2 * 4 * (row + 4)
    adagrad = {"sparse_optimizer": "rowwise_adagrad"}
    assert counts.host_tier_bound_s(cfg, adagrad, ids, [1], True) == \
        2 * (row + 4) / counts.PCIE_BYTES_PER_S
    with pytest.raises(ValueError):
        counts.table_bytes({**cfg, "n_hot": [2, 2]}, {}, 2, ids, [0], False)


def _multi_hot_batch(sizes, n_hot, b, g):
    return torch.cat([torch.randint(0, n, (b, n_hot), generator=g)
                      for n in sizes], dim=1).to(torch.int32)


def test_the_reference_pools_multi_hot_as_a_loop_over_columns():
    sizes = [3, 40, 7, 300, 90, 11]
    g = torch.Generator().manual_seed(3)
    sparse = _multi_hot_batch(sizes, 3, 64, g)
    ids = [torch.arange(n) for n in sizes]
    values = [torch.randn((n, 8), generator=g) for n in sizes]
    rows = ref.Rows(ids, values, [3] * len(sizes))
    pos = rows.index(sparse)
    table_of = [t for t in range(len(sizes)) for _ in range(3)]
    want = torch.zeros((64, len(sizes), 8))
    for col, t in enumerate(table_of):
        want[:, t] += values[t][sparse[:, col].long()]
    assert torch.equal(rows.pooled(pos), want)
    looked_up = torch.stack([values[t][sparse[:, col].long()]
                             for col, t in enumerate(table_of)], dim=1)
    assert torch.equal(ref.pool(looked_up, [3] * len(sizes)), want)
    # every hit of a table takes its pooled row's gradient
    d_pooled = torch.randn((64, len(sizes), 8), generator=g)
    grads = ref.summed_row_grads(d_pooled, pos, rows)
    for t, n in enumerate(sizes):
        loop = torch.zeros((n, 8))
        for i in range(64):         # example by example, column by column
            for col in (c for c, u in enumerate(table_of) if u == t):
                loop[int(sparse[i, col])] += d_pooled[i, t]
        assert torch.equal(grads[t], loop), t
    with pytest.raises(ValueError):
        rows.index(sparse[:, :-1])


def test_a_multi_hot_step_of_the_reference_moves_every_touched_row():
    sizes = [3, 40, 7, 300, 90]
    cfg = {"model": "dlrm", "table_sizes": sizes, "feature_size": 8,
           "bottom_mlp": [13, 16, 8], "top_mlp": [32, 1]}
    g = torch.Generator().manual_seed(4)
    dense = program.draw_dense(g, cfg, "cpu")
    sparse = _multi_hot_batch(sizes, 2, 32, g)
    ids = [torch.unique(sparse[:, 2 * t:2 * t + 2].long())
           for t in range(len(sizes))]
    values = [torch.randn((len(i), 8), generator=g) * 0.1 for i in ids]
    rows = ref.Rows(ids, values, [2] * len(sizes))
    job = {"lr": 0.01, "eps": 1e-10, "dense_optimizer": "adagrad",
           "sparse_optimizer": "rowwise_adagrad"}
    trainer = ref.Trainer(dense, rows, job)
    loss, dgrads, tgrads = trainer.step(
        {"dense": torch.randn((32, 13), generator=g), "sparse": sparse,
         "labels": (torch.rand(32, generator=g) < 0.5).float()})
    assert math.isfinite(loss)
    assert len(dgrads) == len(ref.leaves(dense))
    for t in range(len(sizes)):
        assert bool((rows.acc[t] > 0).all()), t
        assert not torch.equal(rows.values[t], values[t])


def test_program_config_holds_the_hotness():
    cell = spec.load_cell(TRAIN)
    cfg, mix = program.tiny(cell.config, cell.traffic)
    ns = program.parse(program.cli(cfg, mix, True))
    assert program.program_config(ns, cfg, "cpu").n_hot == 1
    with pytest.raises(SystemExit, match="n_hot"):
        program.program_config(ns, {**cfg, "n_hot": 3}, "cpu")
    ns3 = program.parse(program.cli(
        {**cfg, "program_args": cfg["program_args"] + ["--n-hot", "3"]},
        mix, True))
    assert program.program_config(ns3, {**cfg, "n_hot": 3}, "cpu").n_hot == 3
    # an all-equal list is its int; a list that differs is refused
    assert program.program_config(ns3, {**cfg, "n_hot": [3] * 26},
                                  "cpu").n_hot == 3
    with pytest.raises(SystemExit, match="n_hot"):
        program.program_config(ns3, {**cfg, "n_hot": [3] * 25 + [2]}, "cpu")
    assert program.traffic_bytes(mix, {**cfg, "n_hot": 3}) == \
        mix["pool_batches"] * mix["batch"] * (13 * 4 + 78 * 4 + 4)


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_the_harness_imports_no_reference_by_name():
    for path in spec.HERE.glob("**/*.py"):
        if "tests" in path.parts or "reference" in path.parts:
            continue
        bad = [m for m in _imported(path) if m.startswith(
            ("benchmark.reference", "reference"))]
        assert not bad, (path, bad)


def test_readers_count_the_model_of_the_configuration():
    cell = spec.load_cell(TRAIN)
    ctx = dataclasses.make_dataclass("Ctx", ["window", "trace", "cfg",
                                              "batch", "train"])(
        {"steps": 10, "seconds": 1.0}, object(), cell.config, 32768, True)
    assert readers.mfu(ctx) == pytest.approx(
        100.0 * 10 * 6 * 2_410_112 * 32768 / counts.F32_FLOPS)


# MLPerf DLRM-DCNv2's hotness a table (mlcommons/training,
# recommendation_v2/torchrec_dlrm, the README's run command)
MLPERF_HOT = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
              100, 27, 10, 3, 1, 1]


@pytest.mark.parametrize("seed", [7, 2**31 + 5, 3_100_000_007])
def test_a_tables_columns_are_a_prefix_of_its_columns_at_a_larger_hotness(
        seed):
    """At a mixed hotness each table's H_t columns are the first H_t of
    its columns at a uniform hotness of 100, seed for seed; the dense
    features, one-hot ids and labels are the one-hot pool's, and the
    program is handed the flat (B, sum H) ids."""
    sizes = [10**6 if h >= 10 else 1000 + 37 * t
             for t, h in enumerate(MLPERF_HOT)]
    mix = {"ids": {"law": "zipf", "a": 1.2}}
    kw = dict(batch=256, n_batches=2, pinned=False)
    one = traffic.make_pool(mix, sizes, 13, seed, "cpu", **kw)
    wide = traffic.make_pool(mix, sizes, 13, seed, "cpu", n_hot=100, **kw)
    mixed = traffic.make_pool(mix, sizes, 13, seed, "cpu", n_hot=MLPERF_HOT,
                              **kw)
    assert mixed.hot == MLPERF_HOT
    assert mixed.sparse.shape == (2, 256, 214)
    assert mixed.batch(1)["sparse"].shape == (256, 214)
    for t, h in enumerate(MLPERF_HOT):
        cols = traffic.table_columns([t], MLPERF_HOT)
        assert cols == list(range(sum(MLPERF_HOT[:t]),
                                  sum(MLPERF_HOT[:t + 1])))
        assert torch.equal(mixed.sparse[..., cols],
                           wide.sparse[..., 100 * t:100 * t + h]), t
        assert torch.equal(mixed.sparse[..., cols[0]], one.sparse[..., t])
    for key in ("dense", "labels"):
        assert torch.equal(getattr(mixed, key), getattr(one, key))
        assert torch.equal(getattr(wide, key), getattr(one, key))


def test_an_all_equal_list_is_its_int_in_the_pool_and_the_counts():
    cell = spec.load_cell(TIERED)
    cfg, job = cell.config, cell.traffic
    listed = {**cfg, "n_hot": [3] * 26}
    three = {**cfg, "n_hot": 3}
    pools = [traffic.make_pool(job, cfg["table_sizes"], 13, 2**33 + 1, "cpu",
                               batch=512, n_batches=2, pinned=False,
                               n_hot=c["n_hot"]) for c in (three, listed)]
    assert pools[0].hot == pools[1].hot == [3] * 26
    for key in ("dense", "sparse", "labels"):
        assert _sha(getattr(pools[0], key)) == _sha(getattr(pools[1], key))
    assert pools[1].batch(0)["sparse"].shape == (512, 26, 3)
    ids = pools[0].sparse[0]
    host = cfg["tiers"]["host_tables"]
    dev = [t for t in range(26) if t not in host]
    for train in (True, False):
        assert counts.table_bytes(three, job, 512, ids, dev, train) == \
            counts.table_bytes(listed, job, 512, ids, dev, train)
        assert counts.host_tier_bound_s(three, job, ids, host, train) == \
            counts.host_tier_bound_s(listed, job, ids, host, train)
    assert program.traffic_bytes(job, three) == \
        program.traffic_bytes(job, listed)


def test_mixed_hotness_counts_equal_hand_worked_numbers():
    # tables of hotness 2, 1, 3: columns 0-1, 2, 3-5
    ids = torch.tensor([[0, 1, 4, 2, 2, 7],
                        [1, 1, 5, 2, 8, 9]], dtype=torch.int32)
    hot = [2, 1, 3]
    cfg = {"feature_size": 4, "n_hot": hot, "table_sizes": [2, 6, 10],
           "num_dense": 13}
    assert traffic.table_columns([2, 0], hot) == [3, 4, 5, 0, 1]
    # table 0: {0, 1}; table 1: {4, 5}; table 2: {2, 7, 8, 9}
    assert counts.distinct_rows(ids, [0, 1, 2], hot) == 8
    assert counts.distinct_rows(ids, [0, 2], hot) == 6
    assert counts.distinct_rows(ids, [1], hot) == 2
    row, dev = 16, [0, 2]
    # 6 distinct rows; 2 examples x (2 + 3) hits
    serve = 6 * row + 10 * (row + 4)
    assert counts.table_bytes(cfg, {}, 2, ids, dev, False) == serve == 296
    rowwise = {"sparse_optimizer": "rowwise_adagrad"}
    assert counts.table_bytes(cfg, rowwise, 2, ids, dev, True) == \
        serve + 6 * (3 * row + 4 + 8 + 4) == 680
    sgd = {"sparse_optimizer": "sgd"}
    assert counts.table_bytes(cfg, sgd, 2, ids, dev, True) == \
        serve + 10 * (row + 4) + 2 * 6 * row == 688
    # host tables 1 and 2: 6 distinct rows to the card when scoring; in
    # row-wise training 4 of table 2 with their accumulators each way
    assert counts.host_tier_bound_s(cfg, {}, ids, [1, 2], False) == \
        6 * row / counts.PCIE_BYTES_PER_S
    assert counts.host_tier_bound_s(cfg, rowwise, ids, [2], True) == \
        4 * (row + 4) / counts.PCIE_BYTES_PER_S
    mix = {"pool_batches": 4, "batch": 8}
    assert program.traffic_bytes(mix, cfg) == 4 * 8 * (13 * 4 + 6 * 4 + 4)
    # the MLPerf list at B=8192 and 256 batches: 214 ids an example,
    # 1,795,162,112 bytes of ids
    mlperf = {**_config("terabyte-mlperf"), "n_hot": MLPERF_HOT}
    big = {"pool_batches": 256, "batch": 8192}
    assert program.traffic_bytes(big, mlperf) == \
        256 * 8192 * (13 * 4 + 214 * 4 + 4)


def _mixed_batch(sizes, hot, b, g):
    return torch.cat([torch.randint(0, n, (b, h), generator=g)
                      for n, h in zip(sizes, hot)], dim=1).to(torch.int32)


@pytest.mark.parametrize("sparse_opt", ["rowwise_adagrad", "sgd"])
def test_the_reference_at_mixed_hotness_equals_a_per_table_loop(sparse_opt):
    """``Rows``, ``pool`` and a ``Trainer`` step at hotness 3,1,6,2,1,4
    against a plain loop: each table's H_t rows gathered and summed, each
    hit given its pooled row's gradient, the touched rows updated."""
    sizes, hot = [3, 40, 7, 300, 90, 11], [3, 1, 6, 2, 1, 4]
    cfg = {"model": "dlrm", "table_sizes": sizes, "feature_size": 8,
           "bottom_mlp": [13, 16, 8], "top_mlp": [32, 1]}
    g = torch.Generator().manual_seed(5)
    b = 48
    sparse = _mixed_batch(sizes, hot, b, g)
    values = [torch.randn((n, 8), generator=g) * 0.1 for n in sizes]
    rows = ref.Rows([torch.arange(n) for n in sizes], values, hot)
    pos = rows.index(sparse)
    cols = [traffic.table_columns([t], hot) for t in range(len(sizes))]
    want = torch.zeros((b, len(sizes), 8))
    for t, cs in enumerate(cols):
        for c in cs:
            want[:, t] += values[t][sparse[:, c].long()]
    assert torch.equal(rows.pooled(pos), want)
    looked_up = torch.stack([values[t][sparse[:, c].long()]
                             for t, cs in enumerate(cols) for c in cs], dim=1)
    assert torch.equal(ref.pool(looked_up, hot), want)
    with pytest.raises(ValueError):
        ref.pool(looked_up, [3] * 6)
    with pytest.raises(ValueError):
        ref.Rows(rows.ids, values, hot[:-1])

    dense = program.draw_dense(g, cfg, "cpu")
    batch = {"dense": torch.randn((b, 13), generator=g), "sparse": sparse,
             "labels": (torch.rand(b, generator=g) < 0.5).float()}
    job = {"lr": 0.01, "eps": 1e-10, "dense_optimizer": "adagrad",
           "sparse_optimizer": sparse_opt}
    loss, dgrads, tgrads = ref.Trainer(dense, rows, job).step(batch)
    loss2, dgrads2, d_pooled = ref.loss_and_grads(dense, want, batch["dense"],
                                                  batch["labels"])
    assert loss == float(loss2)
    assert all(torch.equal(a, c) for a, c in zip(dgrads, dgrads2))
    lr = float(torch.tensor(0.01, dtype=torch.float32))
    for t, (n, cs) in enumerate(zip(sizes, cols)):
        grad = torch.zeros((n, 8))
        for i in range(b):          # example by example, column by column
            for c in cs:
                grad[int(sparse[i, c])] += d_pooled[i, t]
        assert torch.equal(tgrads[t], grad), t
        touched = torch.unique(sparse[:, cs].long())
        v, gt = values[t].clone(), grad[touched]
        if sparse_opt == "sgd":
            v[touched] -= lr * gt
        else:
            acc = torch.zeros(n)
            acc[touched] += (gt * gt).mean(dim=1)
            a = acc[touched]
            scale = torch.where(a > 0, torch.rsqrt(a + 1e-10),
                                torch.zeros_like(a))
            v[touched] -= lr * gt * scale[:, None]
            assert torch.equal(rows.acc[t], acc), t
        assert torch.equal(rows.values[t], v), t


@pytest.mark.parametrize("name", CELLS)
def test_a_mixed_hotness_configuration_stops_at_the_programs_door(
        name, monkeypatch):
    """With today's port (one hotness for every table) a configuration
    with MLPerf's hotness list ends the CPU dry path in ``program_config``,
    naming both hotnesses, before any weight or batch is drawn."""
    from benchmark import harness

    def drawn(*a, **k):
        raise AssertionError("a weight or batch was drawn")

    for mod, fn in ((program, "draw_dense"), (program, "fill_tables"),
                    (traffic, "make_pool"), (traffic, "draw")):
        monkeypatch.setattr(mod, fn, drawn)
    cell = spec.load_cell(name)
    cell = dataclasses.replace(cell, config={**cell.config,
                                             "n_hot": MLPERF_HOT})
    want = (r"n_hot: the program's 1, the configuration's "
            r"\[3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, "
            r"12, 100, 27, 10, 3, 1, 1\]")
    with pytest.raises(SystemExit, match=want):
        harness.run_cell(cell, 7, 0.3, False, "cpu", tiny=True)
