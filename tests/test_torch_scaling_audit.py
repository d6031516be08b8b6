"""The port's collective audit (``dlrm_tpu_torch/parallel/audit.py`` and
``scaling_audit_torch.py``) against the placement and against the JAX
package's HLO audit (``scaling_audit.py``) on the CPU.

Gloo gangs (``torch_gang_worker.py``'s ``audit`` task) run one step of
``make_sharded_train_step`` under the collective counter:

* at world 2 (1-D) and 2 x 2, on the 6-table tiny model, every placement
  kind (slots, row shards, column shards, host rows) and the bf16
  exchange: the issued collectives equal :func:`placement_formula`, op for
  op, dtype and byte for byte, on every rank;
* at the JAX audit's shapes (fs=128, 26 tables of ``AUDIT_ROWS``,
  production MLPs, 64 rows a rank), mesh 2 and 4 and 2 x 2, f32 and bf16
  exchange: the link bytes a rank by op kind (by axis on 2 x 2) equal
  ``scaling_audit.audit`` / ``audit_hybrid`` on the 8-device CPU mesh,
  the placements equal first, table by table.  The differences are
  asserted at their exact size, none by a tolerance:

  - the port gathers the ids twice (the lookup, ``embedding.py``
    ``_lookup_body``, and the update, ``_update_body``); XLA's CSE folds
    the JAX step's two gathers of the same ids into one (its
    pre-optimization HLO has both);
  - bf16: the JAX CPU lowering widens sub-f32 collectives, so its wire
    bytes are the optimised total less ``exchange_savings``; gloo carries
    the port's bf16 as issued;
  - the dense all-reduce carries the loss in both (XLA's combiner puts it
    in the gradients' all-reduce): no difference.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import scaling_audit as jsa
import scaling_audit_torch as tsa
from dlrm_tpu.config import DLRMConfig as JaxConfig
from dlrm_tpu.parallel.placement import plan_placement as jax_plan
from dlrm_tpu_torch.parallel import audit
from dlrm_tpu_torch.parallel import mesh as pmesh
from dlrm_tpu_torch.parallel.placement import plan_placement
from test_torch_sharded_lookup import spec_config, tiny
from torch_gang_worker import REPO, run_gang

B = 16        # rows a rank, tiny model
PROD_B = 64   # rows a rank at the JAX audit's shapes
KINDS = {
    "slots": ({}, None, 1),
    "row-shards": ({"max_rows_per_shard": 350}, None, 1),
    "column-shards": ({"col_sharded_tables": [3]}, None, 1),
    "host-rows": ({"host_tables": [1, 5]}, None, 1),
    "every-kind-multihot": ({"max_rows_per_shard": 350,
                             "col_sharded_tables": [3],
                             "host_tables": [5]}, None, 2),
    "every-kind-bf16": ({"max_rows_per_shard": 350,
                         "col_sharded_tables": [3],
                         "host_tables": [5]}, "bf16", 1),
}
MESHES = {"2": (None, 2), "2x2": ([2, 2], 4)}
# the port's axis names against the JAX audit's
AXES = {"d": "ici", "h": "dcn", "mesh": "mesh"}


def dense_params(config) -> int:
    sizes = [config.bottom_mlp_sizes, config.full_top_mlp_sizes]
    return sum(a * b + b for s in sizes for a, b in zip(s[:-1], s[1:]))


def placement_formula(config, p, n_h: int, b: int, xd) -> list:
    """The collectives one sharded SGD step must issue, in issue order, as
    (kind, dtype, result bytes, group size, axis): the lookup's ids
    all-gather, slot all-to-all, row shards' reduce-scatter and one
    all-to-all a column shard; the dense all-reduce (gradients and the
    loss) over the whole gang; on a 2-D mesh the DCN fold of the ids and
    of the pooled gradient; then the update's ids all-gather and the
    inverse exchanges, on ``n_h * b`` rows.  Host rows ride the row
    shards' collectives."""
    n, t, d, h = p.num_shards, config.num_tables, config.feature_size, \
        config.n_hot
    w, wire = (2, "bf16") if xd else (4, "f32")
    k, n_rs, n_cs = p.slots_per_shard, len(p.row_sharded), \
        len(p.col_sharded)
    slots = bool(p.slot_table_list)

    def ids(rows, group, axis):
        return ("all-gather", "s32", group * rows * t * h * 4, group, axis)

    def fwd(rows):
        return ([ids(rows, n, "d")]
                + [("all-to-all", wire, n * rows * k * d * w, n, "d")] * slots
                + [("reduce-scatter", wire, rows * n_rs * d * w, n, "d")]
                * bool(n_rs)
                + [("all-to-all", wire, rows * d * w, n, "d")] * n_cs)

    def bwd(rows):
        return ([ids(rows, n, "d")]
                + [("all-to-all", wire, n * rows * k * d * w, n, "d")] * slots
                + [("all-gather", wire, n * rows * n_rs * d * w, n, "d")]
                * bool(n_rs)
                + [("all-to-all", wire, rows * d * w, n, "d")] * n_cs)

    whole = "mesh" if n_h > 1 else "d"   # a 1-D mesh's axis is the gang
    out = fwd(b) + [("all-reduce", "f32", (dense_params(config) + 1) * 4,
                     n * n_h, whole)]
    if n_h > 1:
        out += [ids(b, n_h, "h"),
                ("all-gather", wire, n_h * b * t * d * w, n_h, "h")]
    return out + bwd(n_h * b)


def prod_config(xd) -> dict:
    """``scaling_audit_torch.audit_config(128)`` as a gang spec."""
    c = tsa.audit_config(128)
    return {**spec_config(c), "small_table_threshold": 0,
            "exchange_dtype": xd}


def _records(rank: dict, i: int) -> list:
    return [(str(k), str(dt), int(nb), int(g), str(a)) for k, dt, nb, g, a
            in zip(*(rank[f"{i}.{f}"] for f in ("kind", "dtype", "bytes",
                                                  "group", "axis")))]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Two gangs: 2 ranks (1-D) and 4 ranks (1-D and 2 x 2), each running
    the tiny cases and the JAX audit's shapes.  ``{(mesh, case):
    [records of each rank]}``."""
    runs = {2: [], 4: []}
    for mesh, (shape, world) in MESHES.items():
        for name, (kw, xd, h) in KINDS.items():
            runs[world].append(((mesh, name), {
                "config": spec_config(tiny(h), exchange_dtype=xd),
                "placement": kw, "mesh": shape, "batch": B}))
    for mesh, shape, world in (("2", None, 2), ("4", None, 4),
                               ("2x2", [2, 2], 4)):
        for xd in (None, "bf16"):
            runs[world].append(((mesh, f"fs128-{xd or 'f32'}"), {
                "config": prod_config(xd), "placement": {}, "mesh": shape,
                "batch": PROD_B}))
    out = {}
    for world, cases in runs.items():
        ranks = run_gang(tmp_path_factory.mktemp(f"audit{world}"), world,
                         {"task": "audit", "cases": [c for _, c in cases]},
                         {})
        for i, (key, _) in enumerate(cases):
            out[key] = [_records(r, i) for r in ranks]
    return out


@pytest.mark.parametrize("case", list(KINDS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_issued_collectives_are_the_placements(gangs, mesh, case):
    kw, xd, h = KINDS[case]
    shape, world = MESHES[mesh]
    n_h = shape[0] if shape else 1
    config = tiny(h)
    p = plan_placement(config.table_sizes, world // n_h, **kw)
    want = placement_formula(config, p, n_h, B, xd)
    for r, got in enumerate(gangs[(mesh, case)]):
        assert got == want, f"rank {r}"


@pytest.mark.parametrize("n", [2, 4])
def test_placements_match_jax(n):
    """The JAX audit plans with its config's lane packing, 1 at fs=128,
    so both packages place every table on the same shard and slot."""
    sizes = (jsa.AUDIT_ROWS,) * 26
    pack = JaxConfig(bottom_mlp_sizes=(13, 512, 256, 128),
                     top_mlp_sizes=(1024, 1024, 512, 256, 1),
                     feature_size=128, table_sizes=sizes).pack
    assert pack == 1 and tsa.AUDIT_ROWS == jsa.AUDIT_ROWS
    jp, tp = jax_plan(sizes, n, pack=pack), plan_placement(sizes, n)
    for t in range(26):
        assert (tp.table_shard[t], tp.table_slot[t],
                tp.table_local_offsets[t]) == (jp.table_shard[t],
                                               jp.table_slot[t],
                                               jp.table_local_offsets[t])
    for field in ("slot_tables", "slot_valid", "slot_local_offsets"):
        np.testing.assert_array_equal(getattr(tp, field), getattr(jp, field))
    assert (tp.slots_per_shard, tp.local_rows, tp.row_sharded,
            tp.col_sharded) == (jp.slots_per_shard, jp.local_rows,
                                jp.row_sharded, jp.col_sharded)


@pytest.fixture(scope="module")
def jax_audit():
    """``jax_audit(n, xd)``: ``scaling_audit.audit``; ``jax_audit(dcn,
    ici, xd)``: ``audit_hybrid``; at fs=128, 64 rows a chip, each lowered
    once."""
    done = {}

    def run(*key):
        if key not in done:
            xd = jnp.bfloat16 if key[-1] else None
            done[key] = (jsa.audit(key[0], PROD_B, 128, exchange_dtype=xd)
                         if len(key) == 2 else
                         jsa.audit_hybrid(key[0], key[1], PROD_B, 128,
                                          exchange_dtype=xd))
        return done[key]

    return run


@pytest.mark.parametrize("xd", [None, "bf16"])
@pytest.mark.parametrize("n", [2, 4])
def test_link_bytes_match_the_jax_hlo_audit(gangs, jax_audit, n, xd):
    by_kind, _, n_ops, saved = jax_audit(n, xd)
    records = gangs[(str(n), f"fs128-{xd or 'f32'}")][0]
    port = audit.by_kind([audit.Collective(*r) for r in records])
    assert set(port) == set(by_kind) == {"all-gather", "all-to-all",
                                         "all-reduce"}
    # the update's gather of the ids the lookup gathered already: one
    # more all-gather of (n * 64, 26) int32
    twice = audit.link_bytes("all-gather", n * PROD_B * 26 * 4, n)
    assert port["all-gather"] == (by_kind["all-gather"][0] + 1,
                                  by_kind["all-gather"][1] + twice)
    assert len(records) == n_ops + 1
    # the loss rides in the gradients' all-reduce in both packages
    c = tsa.audit_config(128)
    assert [r[2] for r in records if r[0] == "all-reduce"] == [
        (dense_params(c) + 1) * 4]
    assert port["all-reduce"] == tuple(by_kind["all-reduce"])
    # bf16: the JAX wire bytes are the widened total less the savings,
    # all of them the pooled all-to-alls' (the ids stay int32)
    assert port["all-to-all"] == (by_kind["all-to-all"][0],
                                  by_kind["all-to-all"][1] - saved)
    assert (saved > 0) == bool(xd)


@pytest.mark.parametrize("xd", [None, "bf16"])
def test_hybrid_axes_match_the_jax_hlo_audit(gangs, jax_audit, xd):
    """2 x 2: the DCN fold changes the ids the update gathers, so XLA has
    nothing to fold and the two inventories agree axis by axis and kind by
    kind; bf16 as in 1-D, per axis."""
    per_axis, totals, saved = jax_audit(2, 2, xd)
    records = gangs[("2x2", f"fs128-{xd or 'f32'}")][0]
    port = audit.by_axis([audit.Collective(*r) for r in records])
    assert {AXES[a] for a in port} == set(per_axis) == {"ici", "dcn",
                                                         "mesh"}
    for axis, kinds in port.items():
        jax_kinds = per_axis[AXES[axis]]
        assert {k: v[0] for k, v in kinds.items()} == {
            k: v[0] for k, v in jax_kinds.items()}, axis
        assert sum(v[1] for v in kinds.values()) == \
            totals[AXES[axis]] - saved.get(AXES[axis], 0.0), axis
    assert bool(saved) == bool(xd)


@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter",
                                  "all-reduce", "all-to-all",
                                  "collective-permute"])
def test_link_bytes_is_the_jax_cost_model(kind):
    for n in range(1, 9):
        for nbytes in (0, 1, 4096, 13312, 1703936, 9475592):
            assert audit.link_bytes(kind, nbytes, n) == \
                jsa.link_bytes(kind, nbytes, n)


def test_counter_refuses_what_it_does_not_model(tmp_path):
    """A collective the audit does not price (a broadcast) raises rather
    than go uncounted; the modelled ones are recorded with their group."""
    pmesh.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        mesh = pmesh.make_mesh()
        x = torch.ones(3, dtype=torch.bfloat16)
        _, records = audit.count_collectives(mesh, dist.all_reduce, x)
        assert records == [audit.Collective("all-reduce", "bf16", 6, 1,
                                            "d")]
        with pytest.raises(NotImplementedError, match="broadcast"):
            audit.count_collectives(mesh, dist.broadcast, x, 0)
    finally:
        dist.destroy_process_group()


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_script_runs_without_jax(tmp_path):
    """``scaling_audit_torch.py`` imports none of ``jax``, ``dlrm_tpu`` or
    ``scaling_audit``, by its source and in a run beside modules of those
    names that refuse to load: a gang of 2 at fs=16, 8 rows a chip, whose
    JSON holds the placement's collectives and the four rates."""
    script = REPO / "scaling_audit_torch.py"
    assert not _imports(script) & {"jax", "jaxlib", "dlrm_tpu",
                                   "scaling_audit"}
    shutil.copy(script, tmp_path)
    for name in ("jax", "dlrm_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} imported')\n")
    (tmp_path / "scaling_audit.py").write_text(
        "raise ImportError('scaling_audit imported')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(REPO)
    out = tmp_path / "audit.json"
    run = subprocess.run(
        [sys.executable, str(tmp_path / "scaling_audit_torch.py"), "--mesh",
         "2", "--batch-per-chip", "8", "--out", str(out)], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "mesh=2 fs=16 f32 exchange: 5 collectives" in run.stdout
    payload = json.loads(out.read_text())
    assert payload["step_ms"] == tsa.STEP_MS
    assert "NVIDIA H100 80GB HBM3 at 700 W" in payload["step_ms_source"]
    assert set(payload["rates_gb_s"]) == {"100", "200", "400", "450"}
    (s,) = payload["audits"]
    config = tsa.audit_config(16)
    want = placement_formula(config, plan_placement(config.table_sizes, 2),
                             1, 8, None)
    assert [tuple(r) for r in s["collectives"]] == want
    assert set(s["projected_efficiency"]) == {"100", "200", "400", "450"}
