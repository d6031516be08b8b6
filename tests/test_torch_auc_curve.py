"""make_auc_curve_torch.py, the port's time-to-AUC curve, against the JAX
package's curve of make_auc_curve.py on the CPU.

At make_auc_curve.py's tiny config (6 tables, B=256, 40 steps, evaluated
every 20 steps over 2 batches) the same ClickthroughModel seeds go through
both sides: the JAX side in process, as make_auc_curve.py runs it, from
``jax.random.key(0)``; the port's ``curve()`` from the same weights,
carried across by ``io/convert``.  Cases: fs=16 Adagrad in steps and in
K=4 blocks, K=3 blocks (evaluations on the first block boundary at or
after each multiple of 20, and a short last block), and fs=128 row-wise
Adagrad on bf16 tables through the fused interaction (its plain version
on the CPU; the JAX side runs gram, as make_auc_curve.py does).

Tolerances at every point: AUC within 1e-4; accuracy within 2 samples of
the 512 evaluated; the evaluation loss within 1e-5 in f32.  On bf16 tables
the two packages round a small table's update at different places
(``tests/test_torch_optim.py::test_small_table_adagrad_bf16_rounding_bound``:
an entry may land a bf16 step of an update or two away), and every table
of the tiny config is small, so there the loss is held within 1e-3, as
``test_train_step_opt_bf16_tables`` holds bf16 steps.

Also: the bf16 row-wise update rounds once per distinct row (the summed
gradient of a row's hits, one bf16 add); the script end to end in
subprocesses (the payload, AUC rising, no silent CPU fallback,
``--against``); and ``compare``'s tolerances.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import dlrm_tpu
from dlrm_tpu.data.synthetic import ClickthroughModel as JaxClickthrough
from dlrm_tpu.train.metrics import evaluate as jax_evaluate
from dlrm_tpu.train.train import (init_opt_state as jax_init_opt_state,
                                  make_jit_train_block_opt,
                                  make_jit_train_step_opt)
import make_auc_curve_torch as mac
from dlrm_tpu_torch.data.synthetic import ClickthroughModel
from dlrm_tpu_torch.io.convert import params_from_numpy, save_npz
from dlrm_tpu_torch.ops import embedding as temb
from dlrm_tpu_torch.train.train import init_opt_state
from test_torch_model import jax_config, jax_params_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "make_auc_curve_torch.py")
BATCH, STEPS, EVERY, EVAL_BATCHES = 256, 40, 20, 2
AUC_TOL = 1e-4
ACC_TOL = 2 / (EVAL_BATCHES * BATCH)
LOSS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
POINT_KEYS = {"accuracy", "auc", "loss", "examples", "step", "wall_s"}


def _jax_curve(jcfg, jparams, *, optimizer, lr, k):
    """make_auc_curve.py:83-113 in process, with K-step blocks through
    make_jit_train_block_opt (evaluated on the first block boundary at or
    after each multiple of EVERY)."""
    truth = JaxClickthrough(jcfg, seed=12345)
    params = jparams
    opt = jax_init_opt_state(params, config=jcfg, optimizer=optimizer, lr=lr)
    step = (make_jit_train_step_opt(jcfg, optimizer=optimizer, lr=lr)
            if k == 1 else
            make_jit_train_block_opt(jcfg, optimizer=optimizer, lr=lr))
    points = []

    def eval_point(n):
        m = jax_evaluate(params, truth.stream(BATCH, steps=EVAL_BATCHES,
                                              seed=777), jcfg)
        points.append({"accuracy": m["accuracy"], "auc": m["auc"],
                       "loss": m["loss"], "step": n, "examples": n * BATCH})

    eval_point(0)
    batches = list(truth.stream(BATCH, steps=STEPS, seed=1))
    n = 0
    for i in range(0, STEPS, k):
        chunk = batches[i:i + k]
        arrays = [np.stack([b[key] for b in chunk]) if k > 1
                  else chunk[0][key] for key in ("dense", "sparse", "labels")]
        (params, opt), _ = step(params, opt, *arrays)
        prev, n = n, n + len(chunk)
        if n // EVERY > prev // EVERY:
            eval_point(n)
    if points[-1]["step"] != n:
        eval_point(n)
    return points


def _start(fs, interaction=None):
    """(port config, JAX config, the port's params, the numpy params) from
    one JAX init at ``jax.random.key(0)``."""
    tcfg = mac.build_config(fs, tiny=True, interaction=interaction)
    jcfg = dataclasses.replace(jax_config(tcfg), interaction_impl="gram")
    jparams = dlrm_tpu.init_params(jax.random.key(0), jcfg)
    np_params = jax_params_to_numpy(jparams, jcfg)
    return tcfg, jcfg, jparams, np_params


@pytest.mark.parametrize("fs,k,interaction,steps", [
    (16, 1, None, [0, 20, 40]),
    (16, 4, None, [0, 20, 40]),
    (16, 3, None, [0, 21, 40]),
    (128, 1, "fused", [0, 20, 40]),
])
def test_curve_matches_jax(fs, k, interaction, steps):
    tcfg, jcfg, jparams, np_params = _start(fs, interaction)
    assert tcfg.interaction_impl == (interaction or "gram")
    optimizer, lr = mac.defaults(fs)
    tparams = params_from_numpy(np_params, tcfg)
    topt = init_opt_state(tparams, config=tcfg, optimizer=optimizer)
    got = mac.curve(tcfg, tparams, topt, ClickthroughModel(tcfg, seed=12345),
                    optimizer=optimizer, lr=lr, batch=BATCH, steps=STEPS,
                    eval_every=EVERY, eval_batches=EVAL_BATCHES,
                    update_interval=k, device=torch.device("cpu"))
    want = _jax_curve(jcfg, jparams, optimizer=optimizer, lr=lr, k=k)
    assert [p["step"] for p in got] == [p["step"] for p in want] == steps
    assert topt["count"] == STEPS
    loss_tol = LOSS_TOL[tcfg.embedding_dtype]
    for g, w in zip(got, want):
        assert set(g) == POINT_KEYS and g["examples"] == w["examples"]
        assert abs(g["auc"] - w["auc"]) <= AUC_TOL, (g, w)
        assert abs(g["accuracy"] - w["accuracy"]) <= ACC_TOL, (g, w)
        assert abs(g["loss"] - w["loss"]) <= loss_tol, (g, w)
    # the task is learnable at this size (make_auc_curve.py's slow test)
    assert got[-1]["auc"] > got[0]["auc"] + 0.05


@pytest.mark.parametrize("rowwise", [False, True])
def test_bf16_adagrad_rounds_once_per_distinct_row(rowwise, rng):
    """The big-table update on bf16 tables: the hits of a row are summed
    in f32 (in their order), the accumulator takes the sum once, and the
    row takes one bf16 add, ``new = bf16(old + bf16(-lr * g * rs))``, bit
    for bit against that model; untouched rows keep their bits.  Adding
    each hit's share of the same step on its own rounds three times and
    gives other bits."""
    lr = np.float32(0.002)
    emb0 = (rng.normal(size=(9, 8)) * 0.05).astype(np.float32)
    acc0 = np.abs(rng.normal(size=(9,) if rowwise else (9, 8))
                  ).astype(np.float32) * 1e-3
    ids = torch.tensor([2, 7, 2, 2, 5])
    rows = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32)
                            * 0.01).bfloat16()
    start = torch.from_numpy(emb0).bfloat16()
    emb, acc = start.clone(), torch.from_numpy(acc0.copy())
    temb.apply_sparse_adagrad(emb, acc, temb.SparseGrad(ids, rows),
                              float(lr), rowwise=rowwise)

    uniq = ids.unique()                       # ascending, as the port's
    g = torch.zeros(len(uniq), 8)
    for i, r in enumerate(ids.tolist()):      # f32 sums in hit order
        g[(uniq == r).nonzero()[0, 0]] += rows[i].float()
    g2 = (g * g).mean(dim=1) if rowwise else g * g
    want_acc = torch.from_numpy(acc0.copy())
    want_acc[uniq] += g2
    rs = torch.rsqrt(want_acc[uniq] + 1e-10)
    step = g * (rs[:, None] if rowwise else rs) * lr
    want = start.clone()
    want[uniq] = want[uniq] + (-step).bfloat16()
    assert torch.equal(acc, want_acc)
    assert torch.equal(emb, want)
    untouched = [r for r in range(9) if r not in ids.tolist()]
    assert torch.equal(emb[untouched], start[untouched])
    assert (emb[uniq] != start[uniq]).any(dim=1).all()
    per_hit = start.clone()
    for i, r in enumerate(ids.tolist()):
        u = (uniq == r).nonzero()[0, 0]
        per_hit[r] = per_hit[r] + (-(rows[i].float() * rs[u] * lr)
                                   ).bfloat16()
    assert not torch.equal(emb[2], per_hit[2])


def _run(*args, expect_rc=0):
    proc = subprocess.run(
        [sys.executable, SCRIPT, "--tiny", "--batch-size", str(BATCH),
         "--steps", str(STEPS), "--eval-every", str(EVERY),
         "--eval-batches", str(EVAL_BATCHES), *args],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == expect_rc, proc.stderr[-3000:]
    return proc


def test_script_end_to_end(tmp_path):
    """--tiny --device cpu writes the payload; --against passes on an
    identical curve and exits 1 on one shifted by more than a tolerance."""
    out = tmp_path / "curve.json"
    proc = _run("--device", "cpu", "--feature-size", "16", "--out", str(out))
    payload = json.loads(out.read_text())
    assert set(payload) == {"task", "config", "budget_examples", "seed",
                            "curve", "device", "commit"}
    assert payload["device"] == "cpu" and payload["seed"] == 12345
    assert payload["budget_examples"] == STEPS * BATCH
    assert payload["config"] == ("tiny fs=16 B=256 adagrad lr=0.005 gram "
                                 "interaction")
    curve = payload["curve"]
    assert [p["step"] for p in curve] == [0, 20, 40]
    assert all(set(p) == POINT_KEYS for p in curve)
    assert curve[-1]["auc"] > curve[0]["auc"] + 0.05
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line == {"metric": "auc_curve_fs16", "value": curve[-1]["auc"],
                    "unit": "auc", "points": 3}

    again = _run("--device", "cpu", "--feature-size", "16", "--out",
                 str(tmp_path / "again.json"), "--against", str(out))
    assert "within the tolerances" in again.stderr
    shifted = dict(payload, curve=[dict(p) for p in curve])
    shifted["curve"][1]["auc"] += 0.0101
    (tmp_path / "shifted.json").write_text(json.dumps(shifted))
    miss = _run("--device", "cpu", "--feature-size", "16", "--out",
                str(tmp_path / "third.json"), "--against",
                str(tmp_path / "shifted.json"), expect_rc=1)
    assert "MISS" in miss.stderr and "OUTSIDE the tolerances" in miss.stderr
    assert json.loads(miss.stdout.strip().splitlines()[-1])["points"] == 3


def test_script_refuses_to_fall_back_to_the_cpu(tmp_path):
    """Without --device the script runs on cuda; with no GPU it stops
    before any work (the subprocess sees no CUDA device)."""
    proc = _run("--feature-size", "16", "--out", str(tmp_path / "c.json"),
                expect_rc=1)
    assert "--device cpu" in proc.stderr
    assert not (tmp_path / "c.json").exists()


def test_script_starts_from_params(tmp_path):
    """--params carries the JAX package's initial weights across: the
    script's first point is the in-process curve's first point."""
    tcfg, jcfg, jparams, np_params = _start(128, "fused")
    save_npz(str(tmp_path / "p.npz"), np_params)
    _run("--device", "cpu", "--feature-size", "128", "--interaction",
         "fused", "--steps", "0", "--params", str(tmp_path / "p.npz"),
         "--out", str(tmp_path / "c.json"))
    got = json.loads((tmp_path / "c.json").read_text())
    assert got["config"] == ("tiny fs=128 B=256 rowwise_adagrad lr=0.002 "
                             "bf16-tables fused interaction")
    want = _jax_curve(jcfg, jparams, optimizer="rowwise_adagrad", lr=0.002,
                      k=1)[0]
    point, = got["curve"]
    assert point["step"] == 0 and abs(point["auc"] - want["auc"]) <= AUC_TOL
    assert abs(point["loss"] - want["loss"]) <= 1e-5


def _points(aucs, every=150, batch=32768):
    return [{"step": i * every, "examples": i * every * batch, "auc": a}
            for i, a in enumerate(aucs)]


@pytest.mark.parametrize("aucs,ok", [
    ([0.40, 0.797777, 0.802256, 0.80416], True),   # identical
    ([0.90, 0.797777, 0.802256, 0.80416], True),   # point 0 not compared
    ([0.40, 0.8077, 0.802256, 0.80416], True),     # second: 0.0099 <= 0.01
    ([0.40, 0.8079, 0.802256, 0.80416], False),    # second: 0.0101
    ([0.40, 0.797777, 0.8072, 0.80416], True),     # later: 0.0049 <= 0.005
    ([0.40, 0.797777, 0.8074, 0.80416], False),    # later: 0.0051
    ([0.40, 0.797777, 0.802256, 0.8070], True),    # final: 0.0028 <= 0.003
    ([0.40, 0.797777, 0.802256, 0.8073], False),   # final: 0.0031
])
def test_compare_tolerances(aucs, ok):
    ref = _points([0.478208, 0.797777, 0.802256, 0.80416])
    lines, got = mac.compare(_points(aucs), ref)
    assert got is ok
    assert len(lines) == 3 and all("delta" in line for line in lines)


def test_compare_needs_the_last_point():
    """A curve whose last point has no reference point at equal examples
    fails, and points without a counterpart are named."""
    ref = _points([0.478208, 0.797777, 0.802256])
    lines, ok = mac.compare(_points([0.4, 0.797777, 0.802256, 0.80416]),
                            ref)
    assert not ok and sum("no reference point" in line
                          for line in lines) == 2
    # a committed curve's duplicated last point is one point
    dup = ref + [dict(ref[-1])]
    assert mac.compare(_points([0.4, 0.797777, 0.802256]), dup)[1]
