"""The harness is driven by data: every cell loads by name, a cell added as
files alone runs, the traffic law holds, and the counts give the
hand-worked numbers."""

import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import counts, spec, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.entry in ("train", "serve")
    assert (spec.HERE / "entries" / f"{cell.entry}.py").exists()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert hasattr(spec.load_module("metrics", m["name"]), "read")
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_every_config_file_states_its_sizes():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(cfg["table_sizes"]) == 26 and cfg["dtype"] == "float32"


NEW_CELL = "kaggle-fs128.train-sgd.uniform"


def _add_cell_as_files(tmp: Path) -> Path:
    """A copy of the benchmark with one more cell, one more mix and one
    more per-layer metric, made of new files and new entries alone."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "benchmark/traffic/train-sgd.zipf.json")
                     .read_text())
    mix["ids"] = {"law": "uniform"}
    (tmp / "benchmark/traffic/train-sgd.uniform.json").write_text(
        json.dumps(mix))
    (tmp / f"benchmark/cells/{NEW_CELL}.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-3}}))
    (tmp / "benchmark/metrics/steps_in_window.py").write_text(
        "def read(ctx):\n    return ctx.window['steps']\n")
    bench["workloads"].append({"name": NEW_CELL, "config": "kaggle-fs128",
                               "traffic": "train-sgd.uniform", "chips": 1,
                               "why": "uniform ids"})
    for m in bench["end_to_end"]:
        if "kaggle-fs128.train-rowwise.zipf" in m.get("workloads", []):
            m["workloads"].append(NEW_CELL)
    bench["per_layer"].append({
        "name": "steps_in_window", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train/train.py",
        "moves": "train_examples_per_s", "workloads": [NEW_CELL]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def test_a_cell_added_as_files_alone_runs(tmp_path):
    root = _add_cell_as_files(tmp_path)
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]\n"
        "from benchmark import harness, spec\n"
        f"cell = spec.load_cell({NEW_CELL!r})\n"
        "print(json.dumps(harness.run_cell(cell, 7, 0.3, True, 'cpu', "
        "tiny=True)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["steps_in_window"]["value"] >= 1
    assert list(res)[-1] == "checks"


def test_zipf_law_top_ranks():
    g = torch.Generator().manual_seed(5)
    n = torch.full((400_000,), 10**9, dtype=torch.int64)
    ranks = traffic.zipf_ranks(g, n, 1.2)
    zeta = sum(k ** -1.2 for k in range(1, 2_000_000)) + \
        (2_000_000 ** -0.2) / 0.2
    for r in range(4):
        want = (r + 1) ** -1.2 / zeta
        got = float((ranks == r).double().mean())
        assert abs(got - want) < 4 * math.sqrt(want / 400_000), (r, got, want)


def test_zipf_clamps_at_the_last_row():
    g = torch.Generator().manual_seed(6)
    ranks = traffic.zipf_ranks(g, torch.full((200_000,), 5), 1.2)
    assert int(ranks.min()) == 0 and int(ranks.max()) == 4
    tail = float((ranks == 4).double().mean())
    assert tail > float((ranks == 3).double().mean())


@pytest.mark.parametrize("n", [1, 2, 3, 10, 97, 1000, 4096])
def test_rank_scatter_is_a_bijection(n):
    a, c = traffic.bijection(2**33 + 1, 7, n)
    rows = traffic.scatter(torch.arange(n), torch.tensor(a), torch.tensor(c),
                           torch.tensor(n))
    assert sorted(rows.tolist()) == list(range(n))


def test_pool_is_reproducible_from_the_seed():
    mix = {"ids": {"law": "zipf", "a": 1.2}}
    sizes = [3, 50, 10_000, 10**7]
    seed = 2**31 + 99
    a = traffic.make_pool(mix, sizes, 13, seed, "cpu", batch=256,
                          n_batches=3, pinned=False, chunk=2)
    b = traffic.make_pool(mix, sizes, 13, seed, "cpu", batch=256,
                          n_batches=3, pinned=False, chunk=1)
    c = traffic.make_pool(mix, sizes, 13, seed + 1, "cpu", batch=256,
                          n_batches=3, pinned=False)
    for k in ("dense", "sparse", "labels"):
        assert torch.equal(getattr(a, k), getattr(b, k))
    assert not torch.equal(a.sparse, c.sparse)
    assert int(a.sparse.min()) >= 0
    assert (a.sparse.max(dim=0).values.max(dim=0).values
            < torch.tensor(sizes)).all()
    assert 0.2 < float(a.labels.mean()) < 0.8
    # the batches of a pool all differ
    assert not torch.equal(a.sparse[0], a.sparse[1])


def _cfg(fs):
    return {"model": "dlrm", "table_sizes": [10] * 26, "feature_size": fs,
            "bottom_mlp": [13, 512, 256, fs],
            "top_mlp": [1024, 1024, 512, 256, 1]}


def test_hand_worked_counts():
    assert counts.forward_macs(_cfg(128)) == 2_410_112
    assert counts.forward_macs(_cfg(32)) == 2_253_536
    assert spec.model(_cfg(128)).num_pairs(_cfg(128)) == 351
    assert counts.model_flops(_cfg(128), 32768, True) == \
        6 * 2_410_112 * 32768
    # chip_smoke's interaction bounds at (16384, 27, 128): 257.9 MB forward,
    # 484.4 MB backward, both bound by bytes
    fwd = counts.interaction_bound_s(_cfg(128), 16384, False)
    both = counts.interaction_bound_s(_cfg(128), 16384, True)
    assert round(fwd * counts.HBM_BYTES_PER_S / 1e6, 1) == 257.9
    assert round((both - fwd) * counts.HBM_BYTES_PER_S / 1e6, 1) == 484.4
    # the MLPs' products: 3 * 2.365 M multiply-adds an example, less the
    # first bottom layer's input gradient
    flops = sum(2 * m * k * n for m, k, n in counts.gemms(_cfg(128), 4, True))
    assert flops == 2 * 4 * (3 * 2_365_184 - 13 * 512)


def test_table_bytes_count_distinct_rows():
    cfg = {"feature_size": 4, "n_hot": 1, "table_sizes": [2, 7]}
    ids = torch.tensor([[0, 5], [0, 6], [1, 5]], dtype=torch.int32)
    assert counts.distinct_rows(ids, [0, 1]) == 4
    row = 16
    sgd = counts.table_bytes(cfg, {"sparse_optimizer": "sgd"}, 3, ids,
                             [0, 1], True)
    assert sgd == 4 * row + 6 * (row + 4) + 6 * (row + 4) + 2 * 4 * row
    serve = counts.table_bytes(cfg, {}, 3, ids, [1], False)
    assert serve == 2 * row + 3 * (row + 4)
