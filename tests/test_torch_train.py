"""dlrm_tpu_torch's exact-SGD training against dlrm_tpu's: compressed
embedding gradients, the sparse update, learning-rate schedules, the train
step and loop, and ``python -m dlrm_tpu_torch train``.

The same numpy batches and the same JAX-initialised parameters (logical
tables via ``unpack_tables``, carried over by ``io/convert``) go through
both packages.  f32 tolerance: 1e-5 on losses, dense parameters and logical
tables after 3 steps (sums taken in another order; the JAX package takes
small tables through a one-hot matmul, the port gathers them).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dlrm_tpu
from dlrm_tpu.ops import embedding as jemb
from dlrm_tpu.train.optim import make_schedule as jax_make_schedule
import dlrm_tpu_torch
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.data import criteo as tcriteo
from dlrm_tpu_torch.data.synthetic import ClickthroughModel, random_batch
from dlrm_tpu_torch.io import convert
from dlrm_tpu_torch.io.convert import params_from_numpy
from dlrm_tpu_torch.models import dlrm as tmodel
from dlrm_tpu_torch.ops import embedding as temb
from dlrm_tpu_torch.run import _NOT_YET, main
from dlrm_tpu_torch.train.optim import make_schedule
from test_torch_model import jax_config, jax_params_to_numpy, kaggle_narrow
from test_torch_predict import TABLES, _write_dac

REPO = Path(__file__).resolve().parent.parent
BATCH_KEYS = ("dense", "sparse", "labels")


def _setup(tcfg, packed=True):
    """(JAX config, JAX params, the port's params) from one JAX init."""
    jcfg = dataclasses.replace(jax_config(tcfg), remat=tcfg.remat,
                               packed_tables=packed)
    jparams = dlrm_tpu.init_params(jax.random.key(7), jcfg)
    tparams = params_from_numpy(jax_params_to_numpy(jparams, jcfg), tcfg)
    return jcfg, jparams, tparams


def _train_both(tcfg, *, packed=True, schedule=None, steps=3, batch=32,
                seed=0):
    """``steps`` SGD steps through both packages; returns (port losses,
    JAX losses, port params, JAX params as logical numpy)."""
    jcfg, jparams, tparams = _setup(tcfg, packed)
    if schedule is None:
        jlr = tlr = 0.1
    else:
        jlr = jax_make_schedule(0.1, **schedule)
        tlr = make_schedule(0.1, **schedule)
    jstep = dlrm_tpu.make_jit_train_step(jcfg, jlr)
    tstep = dlrm_tpu_torch.make_train_step(tcfg, tlr)
    rng = np.random.default_rng(seed)
    tl, jl = [], []
    for _ in range(steps):
        b = random_batch(rng, tcfg, batch)
        jparams, loss = jstep(jparams, *(jnp.asarray(b[k])
                                         for k in BATCH_KEYS))
        jl.append(float(loss))
        out = tstep(tparams, *(torch.from_numpy(b[k]) for k in BATCH_KEYS))
        assert out.dim() == 0 and out.dtype == torch.float32
        tl.append(float(out))
    return tl, jl, tparams, jax_params_to_numpy(jparams, jcfg)


def _narrow(**over):
    return dataclasses.replace(kaggle_narrow(), **over)


def _max_diffs(tparams, jnp_params):
    emb = np.abs(tparams["emb"].float().numpy()
                 - jnp_params["emb"].astype(np.float32)).max()
    dense = max(np.abs(layer[k].float().numpy() - jl[k].astype(np.float32)
                       ).max()
                for part in ("bottom", "top")
                for layer, jl in zip(tparams[part], jnp_params[part])
                for k in ("w", "b"))
    return emb, dense


WARMUP = {"schedule": "warmup_poly_decay", "warmup_steps": 2,
          "decay_start": 2, "decay_steps": 4}

F32_CASES = {
    # name: (config overrides, packed, schedule)
    "gram": ({"interaction_impl": "gram"}, True, None),
    "pairwise_3hot": ({"interaction_impl": "pairwise", "n_hot": 3}, True,
                      None),
    "fused": ({"interaction_impl": "fused"}, True, None),
    "fused_3hot_unpacked_sched": ({"interaction_impl": "fused", "n_hot": 3},
                                  False, WARMUP),
    "gram_unpacked_remat_sched": ({"interaction_impl": "gram",
                                   "remat": True}, False, WARMUP),
    "fused_remat": ({"interaction_impl": "fused", "remat": True}, True,
                    None),
    "gram_all_small": ({"interaction_impl": "gram",
                        "small_table_threshold": 1 << 20}, True, None),
    "pairwise_all_big": ({"interaction_impl": "pairwise",
                          "small_table_threshold": 0}, True, WARMUP),
    "gram_pad128": ({"interaction_impl": "gram", "interaction_pad_to": 128},
                    True, None),
}


@pytest.mark.parametrize("name", list(F32_CASES))
def test_train_step_f32_matches_jax(name):
    """26 tables around the small-table threshold (sizes 3..2000, so ids
    repeat within a batch of 32), 3 steps."""
    over, packed, schedule = F32_CASES[name]
    tl, jl, tparams, jparams = _train_both(_narrow(**over),
                                           packed=packed, schedule=schedule)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    emb, dense = _max_diffs(tparams, jparams)
    assert emb <= 1e-5 and dense <= 1e-5, (emb, dense)


@pytest.mark.parametrize("impl", ["gram", "fused"])
@pytest.mark.parametrize("tables", ["bf16", "f32"])
def test_train_step_bf16_matches_jax(impl, tables):
    """--bf16 compute (and bf16 tables): both packages round at the same
    places, but (a) an f32 sum in another order can round an activation to
    its neighbouring bf16 value (2^-8 relative), and (b) JAX sums a small
    table's per-hit gradients in f32 in its one-hot matmul and rounds once,
    where the port rounds each hit's update to the table dtype and adds
    them in it.  So a bf16 table entry may land one or two bf16 steps away
    (2^-8 at the largest entries, 1/sqrt(3)): tables within 1e-2, dense
    parameters within 2e-3, losses within 1e-3."""
    over = {"interaction_impl": impl, "compute_dtype": torch.bfloat16}
    if tables == "bf16":
        over["embedding_dtype"] = torch.bfloat16
    tl, jl, tparams, jparams = _train_both(_narrow(**over))
    np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
    emb, dense = _max_diffs(tparams, jparams)
    assert emb <= 1e-2 and dense <= 2e-3, (emb, dense)
    assert tparams["emb"].dtype == getattr(torch, {"bf16": "bfloat16",
                                                   "f32": "float32"}[tables])


def test_train_step_updates_in_place_and_touches_only_hit_rows():
    tcfg = _narrow(small_table_threshold=0)
    _, _, params = _setup(tcfg)
    emb = params["emb"]
    before = emb.clone()
    b = random_batch(np.random.default_rng(1), tcfg, 16)
    dlrm_tpu_torch.train_step(params, *(torch.from_numpy(b[k])
                                        for k in BATCH_KEYS),
                              config=tcfg, lr=0.1)
    assert params["emb"] is emb
    hit = temb.translate_ids(torch.from_numpy(b["sparse"]),
                             tcfg.table_offsets).reshape(-1).unique()
    changed = (emb != before).any(dim=1).nonzero().reshape(-1)
    assert set(changed.tolist()) <= set(hit.tolist())
    assert len(changed) > 0


def test_init_train_state():
    cfg = tc.tiny_config()
    st = dlrm_tpu_torch.init_train_state(torch.Generator().manual_seed(0),
                                         cfg)
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    assert st.params["emb"].shape == (cfg.total_rows, cfg.feature_size)


# -- compressed embedding gradients --------------------------------------------

def _sparse_setup(n_hot, rng, batch=12):
    tcfg = dataclasses.replace(
        tc.tiny_config(num_tables=3, rows=6, feature_size=8), n_hot=n_hot,
        table_sizes=(6, 9, 40))  # few rows: ids repeat
    jcfg, jparams, tparams = _setup(tcfg, packed=False)
    b = random_batch(rng, tcfg, batch)
    return tcfg, jcfg, jparams, tparams, b


@pytest.mark.parametrize("n_hot", [1, 3])
def test_sparse_value_and_grad_matches_jax(n_hot, rng):
    tcfg, jcfg, jparams, tparams, b = _sparse_setup(n_hot, rng)

    def jloss(dp, pooled, dense, labels):
        return dlrm_tpu.models.dlrm.loss_from_pooled(dp, pooled, dense,
                                                     labels, jcfg)

    def tloss(dp, pooled, dense, labels):
        return tmodel.loss_from_pooled(dp, pooled, dense, labels, tcfg)

    jdp, jemb_ = dlrm_tpu.models.dlrm.split_params(jparams)
    jval, (jdg, jsg) = jemb.sparse_value_and_grad(jloss)(
        jdp, jemb_, jnp.asarray(b["sparse"]), jcfg.table_offsets,
        jnp.asarray(b["dense"]), jnp.asarray(b["labels"]))
    tdp, temb_ = tmodel.split_params(tparams)
    tval, (tdg, tsg) = temb.sparse_value_and_grad(tloss)(
        tdp, temb_, torch.from_numpy(b["sparse"]), tcfg.table_offsets,
        torch.from_numpy(b["dense"]), torch.from_numpy(b["labels"]))
    assert not tval.requires_grad
    np.testing.assert_allclose(float(tval), float(jval), atol=1e-6)
    np.testing.assert_array_equal(tsg.ids.numpy(), np.asarray(jsg.ids))
    np.testing.assert_allclose(tsg.rows.numpy(), np.asarray(jsg.rows),
                               atol=1e-6)
    for part in ("bottom", "top"):
        for tl, jl in zip(tdg[part], jdg[part]):
            for k in ("w", "b"):
                np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                           atol=1e-6)
    # against the dense autodiff oracle: uncompress == d(loss)/d(table)
    emb = temb_.clone().requires_grad_()
    pooled = temb.lookup(emb, torch.from_numpy(b["sparse"]),
                         tcfg.table_offsets)
    (dense_grad,) = torch.autograd.grad(
        tloss(tdp, pooled, torch.from_numpy(b["dense"]),
              torch.from_numpy(b["labels"])), emb)
    want = temb.uncompress(tsg, tcfg.total_rows, tcfg.feature_size)
    np.testing.assert_allclose(want.numpy(), dense_grad.numpy(), atol=1e-7)
    np.testing.assert_allclose(
        want.numpy(), np.asarray(jemb.uncompress(jsg, tcfg.total_rows,
                                                 tcfg.feature_size)),
        atol=1e-6)


def _dup_grad(rng, n=40, rows=7, dim=5):
    ids = rng.integers(0, rows, size=n).astype(np.int32)
    g = rng.normal(size=(n, dim)).astype(np.float32)
    return ids, g


def test_apply_sparse_sgd_sums_duplicates_like_jax(rng):
    ids, g = _dup_grad(rng)
    emb = rng.normal(size=(7, 5)).astype(np.float32)
    want = jemb.apply_sparse_sgd(jnp.asarray(emb),
                                 jemb.SparseGrad(jnp.asarray(ids),
                                                 jnp.asarray(g)),
                                 jnp.float32(0.3))
    t = torch.from_numpy(emb.copy())
    got = temb.apply_sparse_sgd(t, temb.SparseGrad(torch.from_numpy(ids),
                                                   torch.from_numpy(g)), 0.3)
    assert got is t
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_apply_sparse_sgd_bf16_rounds_an_f32_product(rng):
    """bf16 table: ``-lr * rows`` is an f32 product, cast once (the JAX
    package's f32 learning rate)."""
    ids = np.arange(6, dtype=np.int32)
    g = rng.normal(size=(6, 4)).astype(np.float32)
    emb = np.zeros((6, 4), np.float32)
    tg = torch.from_numpy(g).bfloat16()
    got = temb.apply_sparse_sgd(torch.from_numpy(emb).bfloat16(),
                                temb.SparseGrad(torch.from_numpy(ids), tg),
                                0.1)
    want = jemb.apply_sparse_sgd(
        jnp.asarray(emb, jnp.bfloat16),
        jemb.SparseGrad(jnp.asarray(ids),
                        jnp.asarray(tg.float().numpy(), jnp.bfloat16)),
        jnp.float32(0.1))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("max_unique", [None, 9, 5])
def test_dedup_sparse_grad_matches_jax(max_unique, rng):
    ids, g = _dup_grad(rng)
    want = jemb.dedup_sparse_grad(jemb.SparseGrad(jnp.asarray(ids),
                                                  jnp.asarray(g)),
                                  max_unique=max_unique)
    got = temb.dedup_sparse_grad(temb.SparseGrad(torch.from_numpy(ids),
                                                 torch.from_numpy(g)),
                                 max_unique=max_unique)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows),
                               atol=1e-6)
    if max_unique is None:  # nothing dropped: the same dense gradient
        np.testing.assert_allclose(
            temb.uncompress(got, 7, 5).numpy(),
            temb.uncompress(temb.SparseGrad(torch.from_numpy(ids),
                                            torch.from_numpy(g)), 7,
                            5).numpy(), atol=1e-6)


# -- schedules -------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"schedule": "constant"},
    {"schedule": "warmup_poly_decay", "warmup_steps": 5, "decay_start": 9,
     "decay_steps": 7},
    {"schedule": "warmup_poly_decay", "warmup_steps": 4, "decay_start": 4,
     "decay_steps": 10, "end_lr_scale": 0.25},
    {"schedule": "warmup_poly_decay", "warmup_steps": 0, "decay_start": 3,
     "decay_steps": 5},
    {"schedule": "warmup_poly_decay", "warmup_steps": 0, "decay_start": 0,
     "decay_steps": 0},
    {"schedule": "warmup_poly_decay", "warmup_steps": 6, "decay_start": 2,
     "decay_steps": 3},
])
def test_make_schedule_matches_optax(kw):
    ours = make_schedule(0.37, **kw)
    theirs = jax_make_schedule(0.37, **kw)
    got = [ours(s) for s in range(30)]
    want = [float(theirs(s)) for s in range(30)]
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_make_schedule_uses_optax_pieces():
    s = make_schedule(1.0, schedule="warmup_poly_decay", warmup_steps=4,
                      decay_start=6, decay_steps=4)
    lin = optax.linear_schedule(0.0, 1.0, 4)
    assert [s(i) for i in range(4)] == [float(lin(i)) for i in range(4)]
    assert s(4) == s(5) == 1.0 and s(10) == 0.0
    with pytest.raises(ValueError, match="unknown schedule"):
        make_schedule(0.1, schedule="cosine")


# -- the loop and the CLI --------------------------------------------------------

@pytest.mark.parametrize("sync_every", [1, 4])
def test_train_loop_matches_jax(sync_every):
    """train() on ClickthroughModel (Zipf ids, planted labels) against the
    JAX package's train(): the same synced losses, 7 steps (a tail window
    shorter than sync_every included)."""
    tcfg = dataclasses.replace(
        tc.tiny_config(num_tables=5, rows=300, feature_size=8))
    jcfg, jparams, tparams = _setup(tcfg)
    data = list(ClickthroughModel(tcfg, seed=12345).stream(48, 7, seed=1))
    seen = []
    res = dlrm_tpu_torch.train(tparams, data, config=tcfg, lr=0.1,
                               sync_every=sync_every,
                               callback=lambda s, l: seen.append(s))
    jres = dlrm_tpu.train(jparams,
                          [{k: jnp.asarray(v) for k, v in b.items()}
                           for b in data], config=jcfg, lr=0.1,
                          sync_every=sync_every)
    np.testing.assert_allclose(res["losses"], jres["losses"], atol=1e-5)
    assert len(res["iteration_times"]) == len(jres["iteration_times"])
    assert seen == ([0, 1, 2, 3, 4, 5, 6] if sync_every == 1 else [3, 6])
    assert res["params"] is tparams
    emb, dense = _max_diffs(tparams, jax_params_to_numpy(jres["params"],
                                                         jcfg))
    assert emb <= 1e-5 and dense <= 1e-5


def test_train_loop_maxiters_and_bad_sync():
    cfg = tc.tiny_config()
    p = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(0), cfg)
    from dlrm_tpu_torch.data.synthetic import batch_stream
    res = dlrm_tpu_torch.train(p, batch_stream(cfg, 8), config=cfg, lr=0.1,
                               maxiters=3)
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    with pytest.raises(ValueError, match="sync_every"):
        dlrm_tpu_torch.train(p, [], config=cfg, lr=0.1, sync_every=0)


def _cli_line(capsys, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _in_process(cfg, data, lr=0.1):
    p = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(cfg.seed),
                                   cfg)
    return dlrm_tpu_torch.train(p, data, config=cfg, lr=lr)["losses"][-1]


_TINY26 = ["--config", "tiny", "--table-sizes", ",".join(map(str, TABLES)),
           "--device", "cpu", "--batch-size", "32"]


def test_cli_train_synthetic_reproduces_in_process(capsys):
    line = _cli_line(capsys, ["train", *_TINY26, "--steps", "9",
                              "--synthetic", "skewed", "--log-every", "4",
                              "--interaction", "fused"])
    assert set(line) == {"steps", "final_loss", "seconds", "device"}
    assert line["steps"] == 9 and line["device"] == "cpu"
    cfg = dataclasses.replace(tc.tiny_config(), table_sizes=TABLES,
                              interaction_impl="fused")
    want = _in_process(cfg, ClickthroughModel(cfg, seed=12345).stream(
        32, 9, seed=1))
    assert line["final_loss"] == want


def test_cli_train_data_shuffled_epochs_reproduce_in_process(tmp_path, rng,
                                                             capsys):
    from dlrm_tpu_torch.data.criteo import DACLoader, load
    data = str(tmp_path / "d.bin")
    _write_dac(data, 200, rng)
    line = _cli_line(capsys, ["train", *_TINY26, "--data", data,
                              "--epochs", "2", "--shuffle-rows",
                              "--shuffle-window", "2", "--seed", "4"])
    assert line["steps"] == 2 * (200 // 32)
    loader = DACLoader(load(data), 32, shuffle_rows=True, shuffle_window=2,
                       seed=4)
    cfg = dataclasses.replace(tc.tiny_config(), table_sizes=TABLES)
    assert line["final_loss"] == _in_process(
        cfg, [b for _ in range(2) for b in loader])


@pytest.mark.parametrize("extra", [
    ["--steps", "4", "--lr-schedule", "warmup_poly_decay", "--warmup-steps",
     "2", "--decay-start", "3", "--decay-steps", "2"],
    ["--steps", "3", "--remat", "--interaction", "pairwise", "--n-hot", "2"],
    ["--steps", "3", "--bf16", "--bf16-tables", "--prefetch", "4"],
    ["--data", "{data}", "--steps", "15", "--shuffle"],
    ["--data", "{data}"],
])
def test_cli_train_flags(extra, tmp_path, rng, capsys):
    data = str(tmp_path / "d.bin")
    _write_dac(data, 200, rng)
    extra = [a.replace("{data}", data) for a in extra]
    line = _cli_line(capsys, ["train", *_TINY26, *extra])
    want = int(extra[extra.index("--steps") + 1]) if "--steps" in extra \
        else 200 // 32  # --data without --steps: one epoch
    assert line["steps"] == want and np.isfinite(line["final_loss"])


@pytest.mark.parametrize("argv,msg", [
    (["--steps", "0", "--epochs", "1", "--data", "x"], "not both"),
    ([], "needs --steps"),
    (["--epochs", "2", "--steps", "3"], "--epochs needs --data"),
])
def test_cli_train_rejects_bad_plans(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        main(["train", "--config", "tiny", "--device", "cpu", *argv])


_REFUSED = [
    ("--hbm-budget-gb", "8", "item 2, 'Two-tier tables'"),
    ("--host-prefetch", None, "item 2, 'Two-tier tables'"),
    ("--sharded", "true", "item 3, 'Multi-GPU'"),
    ("--mesh-shape", "2x4", "item 3, 'Multi-GPU'"),
    ("--paranoid", "10", "item 3, 'Multi-GPU'"),
    ("--max-rows-per-shard", "100", "item 3, 'Multi-GPU'"),
    ("--col-sharded-tables", "1", "item 3, 'Multi-GPU'"),
    ("--host-tables", "1", "item 3, 'Multi-GPU'"),
    ("--exchange-dtype", "bf16", "item 3, 'Multi-GPU'"),
    ("--distributed", None, "item 3, 'Multi-GPU'"),
    ("--coordinator", "localhost:1234", "item 3, 'Multi-GPU'"),
    ("--num-processes", "2", "item 3, 'Multi-GPU'"),
    ("--process-id", "1", "item 3, 'Multi-GPU'"),
]


@pytest.mark.parametrize("flag,value,item", _REFUSED)
def test_cli_train_refuses_unported_flags(flag, value, item):
    argv = ["train", "--config", "tiny", "--steps", "2", "--device", "cpu",
            flag] + ([value] if value is not None else [])
    with pytest.raises(SystemExit, match=f"ROADMAP.md queue 1, {item}"):
        main(argv)


@pytest.mark.parametrize("flag", ["--ckpt-dir", "--save-interval",
                                  "--max-to-keep", "--profile-dir",
                                  "--sharded"])
def test_cli_train_flags_now_served(flag, tmp_path, capsys):
    """Each flag once refused as 'not served yet' runs: 5 steps write the
    checkpoints its values ask for (or a trace), and the losses are those
    of the same run without it."""
    from dlrm_tpu_torch.io import checkpoint as ck

    d = str(tmp_path / "ck")
    extra = {"--ckpt-dir": ["--ckpt-dir", d],
             "--save-interval": ["--ckpt-dir", d, "--save-interval", "2"],
             "--max-to-keep": ["--ckpt-dir", d, "--save-interval", "1",
                               "--max-to-keep", "2"],
             "--profile-dir": ["--profile-dir", str(tmp_path / "prof")],
             "--sharded": ["--sharded", "false"]}[flag]
    base = ["train", *_TINY26, "--steps", "5", "--log-every", "1"]
    want = _cli_line(capsys, base)
    got = _cli_line(capsys, base + extra)
    assert got["final_loss"] == want["final_loss"] and got["steps"] == 5
    steps = {"--ckpt-dir": [5], "--save-interval": [2, 4, 5],
             "--max-to-keep": [4, 5]}.get(flag)
    if steps:
        assert ck.all_steps(d) == steps
        assert json.loads(Path(d, "run_meta.json").read_text())[
            "optimizer"] == "sgd"
    if flag == "--profile-dir":
        assert len(list((tmp_path / "prof").glob("*.json"))) == 1


@pytest.mark.parametrize("cmd", ["train", "eval", "predict"])
def test_cli_validate_data(cmd, tmp_path, rng, capsys):
    """--validate-data: a file whose ids fit the tables runs (train: the
    same loss as without the flag); one with an id past its table stops
    before any parameter is built, naming the record and the column."""
    good, bad = str(tmp_path / "good.bin"), str(tmp_path / "bad.bin")
    _write_dac(good, 100, rng)
    _write_dac(bad, 100, rng)
    recs = np.fromfile(bad, dtype=tcriteo.DAC_DTYPE)
    recs["cat"][57, 4] = TABLES[4] + 1  # 1-based in the file
    recs.tofile(bad)
    pz = str(tmp_path / "p.npz")
    cfg = dataclasses.replace(tc.tiny_config(), table_sizes=TABLES)
    convert.save_npz(pz, convert.params_to_numpy(
        dlrm_tpu_torch.init_params(torch.Generator().manual_seed(1), cfg)))
    argv = {"train": ["train", *_TINY26, "--steps", "2"],
            "eval": ["eval", *_TINY26, "--params", pz],
            "predict": ["predict", *_TINY26, "--params", pz, "--out",
                        str(tmp_path / "s.npy")]}[cmd]
    lines = [_cli_line(capsys, argv + ["--data", good] + flag)
             for flag in (["--validate-data"], [])]
    for line in lines:
        line.pop("seconds", None)
    assert lines[0] == lines[1]
    with pytest.raises(ValueError, match="record 57, column 4: id 4 "
                       r"outside \[1, 4\)"):
        main(argv + ["--data", bad, "--validate-data"])


@pytest.mark.parametrize("flag,value,msg", [
    ("--chunk-budget-mb", "16", "TPU storage layout"),
    ("--platform", "cpu", "pass --device"),
])
def test_cli_refuses_tpu_only_flags(flag, value, msg):
    for cmd in (["train", "--steps", "2"], ["predict", "--out", "o"]):
        with pytest.raises(SystemExit, match=msg):
            main([*cmd, "--config", "tiny", "--device", "cpu", flag, value])


def test_refusal_table_covers_the_jax_train_flags():
    """Every flag of the JAX package's train parser is parsed here, and
    every one this package does not serve is in the refusal table."""
    from dlrm_tpu.run import build_parser as jax_parser
    from dlrm_tpu_torch.run import build_parser

    def train_flags(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, __import__("argparse")._SubParsersAction))
        return {a.dest for a in sub.choices["train"]._actions} - {"help"}

    ours, theirs = train_flags(build_parser()), train_flags(jax_parser())
    assert theirs <= ours, theirs - ours
    served = {"config", "feature_size", "interaction", "n_hot", "bf16",
              "bf16_tables", "pad_to", "table_sizes", "remat", "device",
              "data", "synthetic", "shuffle", "shuffle_rows",
              "shuffle_window", "batch_size", "lr", "lr_schedule",
              "warmup_steps", "decay_start", "decay_steps", "steps",
              "epochs", "seed", "log_every", "prefetch", "optimizer",
              "grad_clip_norm", "adagrad_impl", "update_interval",
              "block_scan", "eval_data", "eval_after", "eval_every",
              "eval_steps", "validate_data", "ckpt_dir", "save_interval",
              "max_to_keep", "profile_dir", "sharded"}
    assert ours - served == set(_NOT_YET)


def test_module_entry_point_trains_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run(
        [sys.executable, "-m", "dlrm_tpu_torch", "train", "--config", "tiny",
         "--steps", "3", "--batch-size", "16", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["steps"] == 3 and line["device"] == "cpu"
    assert np.isfinite(line["final_loss"])
