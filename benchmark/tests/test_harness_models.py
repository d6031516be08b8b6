"""A model enters the benchmark as files alone: the configuration's
``model`` picks its reference module, which gives the dense leaves and the
counts; multi-hot ids reach the traffic, the counts, the entries and the
reference; and the three cells' pools, weights and counts stay as they
were before either existed."""

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
    and the entries, counts and reference read the 78 columns."""
    configs, cells = {}, {}
    for base, like in (("kaggle-fs128", TRAIN), ("terabyte-mlperf", TIERED)):
        cfg = _config(base)
        name = f"{base}-hot3"
        cfg.update(name=name, n_hot=3,
                   program_args=cfg["program_args"] + ["--n-hot", "3"])
        configs[name] = cfg
        cells[f"{name}.train-rowwise.zipf"] = (name, "train-rowwise.zipf",
                                               like)
    cells["kaggle-fs128-hot3.serve-b16384.zipf"] = (
        "kaggle-fs128-hot3", "serve-b16384.zipf", SERVE)
    root = _copy_with(tmp_path, configs, cells)
    results = dict(zip(cells, _run(root, list(cells))))
    for name, res in results.items():
        assert res["correct"] is True, (name, res["checks"])
        assert res["id_columns"] == 78
        emb = res["rooflines"]["embedding"]
        assert emb is not None and math.isfinite(emb) and emb > 0, name
    tiered = results["terabyte-mlperf-hot3.train-rowwise.zipf"]
    host = tiered["rooflines"]["host_tier"]
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
    for bad in ([3] * 26, 0, 1.0, True):
        with pytest.raises(ValueError):
            traffic.hotness(bad)


def test_multi_hot_counts_every_column():
    ids = torch.tensor([[0, 0, 1, 1, 4, 9],
                        [2, 0, 0, 1, 5, 9]], dtype=torch.int32)
    cfg = {"feature_size": 4, "n_hot": 2}
    # table 0: {0, 2}; table 1: {0, 1}; table 2: {4, 5, 9}
    assert traffic.table_columns([0, 2], 2) == [0, 1, 4, 5]
    assert counts.distinct_rows(ids, [0, 1, 2], 2) == 7
    assert counts.distinct_rows(ids, [2], 2) == 3
    row = 16
    serve = counts.table_bytes(cfg, {}, 2, ids, [0, 2], False)
    assert serve == 5 * row + 2 * 4 * (row + 4)
    adagrad = {"sparse_optimizer": "rowwise_adagrad"}
    assert counts.host_tier_bound_s(cfg, adagrad, ids, [1], True) == \
        2 * (row + 4) / counts.PCIE_BYTES_PER_S
    with pytest.raises(ValueError):
        counts.table_bytes({"feature_size": 4, "n_hot": [2, 2, 2]}, {}, 2,
                           ids, [0], False)


def _multi_hot_batch(sizes, n_hot, b, g):
    return torch.cat([torch.randint(0, n, (b, n_hot), generator=g)
                      for n in sizes], dim=1).to(torch.int32)


def test_the_reference_pools_multi_hot_as_a_loop_over_columns():
    sizes = [3, 40, 7, 300, 90, 11]
    g = torch.Generator().manual_seed(3)
    sparse = _multi_hot_batch(sizes, 3, 64, g)
    ids = [torch.arange(n) for n in sizes]
    values = [torch.randn((n, 8), generator=g) for n in sizes]
    rows = ref.Rows(ids, values, 3)
    pos = rows.index(sparse)
    table_of = [t for t in range(len(sizes)) for _ in range(3)]
    want = torch.zeros((64, len(sizes), 8))
    for col, t in enumerate(table_of):
        want[:, t] += values[t][sparse[:, col].long()]
    assert torch.equal(rows.pooled(pos), want)
    looked_up = torch.stack([values[t][sparse[:, col].long()]
                             for col, t in enumerate(table_of)], dim=1)
    assert torch.equal(ref.pool(looked_up, 3), want)
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
    rows = ref.Rows(ids, values, 2)
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
    with pytest.raises(SystemExit, match="n_hot"):
        program.program_config(ns3, {**cfg, "n_hot": [3] * 26}, "cpu")
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
