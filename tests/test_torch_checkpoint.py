"""dlrm_tpu_torch.io.checkpoint: round trips of every kind of leaf bit for
bit, the atomic write, retention, and resume within the port with equal
bits.

Resume goes through ``run._build_step``, the path ``train --ckpt-dir``
takes: N steps straight against N/2 steps, a save, a restore into new
tensors (drawn from another seed, so that every value must come from the
file) and N/2 more, over the same batches; for every optimizer, for K=1
and K=3 blocks, under a constant and a scheduled learning rate, with and
without a clip.  The CPU sums duplicates in one order, so equal bits are
asked for.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import dlrm_tpu_torch
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.data.synthetic import random_batch
from dlrm_tpu_torch.io import checkpoint as ck
from dlrm_tpu_torch.ops.embedding import tree_leaves
from dlrm_tpu_torch.run import _build_step, _train_plan, build_parser
from dlrm_tpu_torch.train import train as ttrain

KEYS = ("dense", "sparse", "labels")


def _cfg(**kw):
    """5 tables, D=8: small ones (6, 9 and 40 rows) whose ids repeat in a
    batch and two big ones under a threshold of 50."""
    return dataclasses.replace(
        tc.tiny_config(feature_size=8), table_sizes=(6, 300, 9, 2000, 40),
        small_table_threshold=50, **kw)


def _init(cfg, seed=3):
    return dlrm_tpu_torch.init_params(torch.Generator().manual_seed(seed),
                                      cfg)


def _leaves(tree):
    """(path, leaf) of every tensor and number of a payload, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            for p, x in _leaves(v):
                yield (k,) + p, x
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            for p, x in _leaves(v):
                yield (i,) + p, x
    elif tree is not None:
        yield (), tree


def assert_bits_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                               y.view(torch.uint8) if y.dim() else y), path
        else:
            assert x == y, path


def _trained_state(cfg, optimizer, steps=2):
    """Parameters and optimizer state after ``steps`` steps, so that no
    leaf is at its initial value."""
    params = _init(cfg)
    opt = ttrain.init_opt_state(params, config=cfg, optimizer=optimizer)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        b = random_batch(rng, cfg, 32)
        ttrain.train_step_opt(params, opt, *(torch.from_numpy(b[k])
                                               for k in KEYS),
                              config=cfg, optimizer=optimizer, lr=0.1)
    return params, opt


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rowwise_adagrad"])
@pytest.mark.parametrize("variant", ["f32", "bf16", "multihot"])
def test_round_trip_every_leaf_bit_for_bit(optimizer, variant, tmp_path,
                                           monkeypatch):
    """A payload of parameters and optimizer state written with a host
    buffer of 96 bytes (every tensor in many chunks) comes back with the
    same bits, as new tensors and into existing ones."""
    over = {"f32": {}, "multihot": {"n_hot": 3},
            "bf16": {"embedding_dtype": torch.bfloat16,
                     "compute_dtype": torch.bfloat16}}[variant]
    cfg = _cfg(**over)
    params, opt = _trained_state(cfg, optimizer)
    payload = {"params": params, "opt": opt}
    monkeypatch.setattr(ck, "BUFFER_BYTES", 96)
    path = ck.save_checkpoint(tmp_path, 2, payload)
    assert path == str(tmp_path / "2")
    got, step = ck.restore_checkpoint(tmp_path)
    assert step == 2
    assert_bits_equal(got, payload)
    assert got["opt"]["count"] == 2 and isinstance(got["opt"]["count"], int)
    # into tensors that exist: the same objects come back, filled
    out = {"params": _init(cfg, seed=9),
           "opt": ttrain.init_opt_state(params, config=cfg,
                                        optimizer=optimizer)}
    filled, _ = ck.restore_checkpoint(tmp_path, out=out)
    assert filled["params"]["emb"] is out["params"]["emb"]
    assert_bits_equal(filled, payload)
    # bf16 leaves lie on disk as their bits
    stored = np.load(tmp_path / "2" / "params.emb.npy")
    assert stored.dtype == (np.uint16 if variant == "bf16" else np.float32)


def test_metadata_without_reading_any_array(tmp_path):
    cfg = _cfg(embedding_dtype=torch.bfloat16)
    params, opt = _trained_state(cfg, "rowwise_adagrad")
    ck.save_checkpoint(tmp_path, 5, {"params": params, "opt": opt})
    for f in (tmp_path / "5").glob("*.npy"):
        f.write_bytes(b"")  # metadata reads none of them
    meta = ck.checkpoint_metadata(tmp_path)
    emb = meta["params"]["emb"]
    assert (emb.shape, emb.dtype) == ((cfg.total_rows, 8), torch.bfloat16)
    assert meta["opt"]["emb"].shape == (cfg.total_rows,)
    assert meta["opt"]["count"] == 2
    assert [tuple(l["w"].shape) for l in meta["params"]["top"]] == [
        tuple(l["w"].shape) for l in params["top"]]


def test_memory_map_of_a_bf16_leaf(tmp_path):
    t = torch.randn(1000, 8, generator=torch.Generator().manual_seed(0)
                    ).bfloat16()
    ck.save_checkpoint(tmp_path, 0, {"emb": t})
    arr = ck.checkpoint_metadata(tmp_path)["emb"].array()
    assert arr.shape == (1000, 8)
    np.testing.assert_array_equal(arr[10:20], t[10:20].float().numpy())
    np.testing.assert_array_equal(np.asarray(arr), t.float().numpy())


def test_leaf_rows_are_read_slice_by_slice(tmp_path):
    t = torch.randn(1000, 8, generator=torch.Generator().manual_seed(1))
    ck.save_checkpoint(tmp_path, 0, {"emb": t, "b": t[0], "e": t[:0]})
    leaves = ck.checkpoint_metadata(tmp_path)
    arr = leaves["emb"].array()
    assert (arr.shape, arr.dtype, len(arr)) == ((1000, 8), np.float32, 1000)
    for s in (slice(0, 7), slice(993, 1000), slice(990, 2000),
              slice(5, 5), slice(-3, None)):
        got = arr[s]
        # a copy: no mapping of the file outlives the read
        assert not isinstance(got, np.memmap) and got.flags.owndata
        np.testing.assert_array_equal(got, t.numpy()[s])
    np.testing.assert_array_equal(arr[[3, 1]], t.numpy()[[3, 1]])
    np.testing.assert_array_equal(np.asarray(leaves["b"].array()),
                                  t[0].numpy())
    assert leaves["e"].array()[0:5].shape == (0, 8)


def test_latest_step_ignores_partial_and_temporary_directories(tmp_path):
    cfg = _cfg()
    params = _init(cfg)
    for s in (3, 10):
        ck.save_checkpoint(tmp_path, s, params)
    os.makedirs(tmp_path / ".tmp-20-abc")          # a save cut short
    (tmp_path / ".tmp-20-abc" / "emb.npy").write_bytes(b"partial")
    os.makedirs(tmp_path / "30")                   # no checkpoint.json
    assert ck.latest_step(tmp_path) == 10
    assert ck.all_steps(tmp_path) == [3, 10]
    assert ck.latest_step(tmp_path / "missing") is None
    _, step = ck.restore_checkpoint(tmp_path, step=3)
    assert step == 3


def test_a_failed_save_leaves_no_checkpoint(tmp_path, monkeypatch):
    cfg = _cfg()
    params = _init(cfg)
    ck.save_checkpoint(tmp_path, 1, params)
    calls = []

    def broken(path, t, buf):
        calls.append(path)
        if len(calls) == 3:
            raise OSError("disk full")
        return real(path, t, buf)

    real = ck._write_tensor
    monkeypatch.setattr(ck, "_write_tensor", broken)
    with pytest.raises(OSError, match="disk full"):
        ck.save_checkpoint(tmp_path, 2, params)
    assert ck.latest_step(tmp_path) == 1
    assert sorted(os.listdir(tmp_path)) == ["1"]


def test_save_replaces_a_step(tmp_path):
    cfg = _cfg()
    a, b = _init(cfg, 1), _init(cfg, 2)
    ck.save_checkpoint(tmp_path, 4, a)
    ck.save_checkpoint(tmp_path, 4, b)
    got, _ = ck.restore_checkpoint(tmp_path)
    assert_bits_equal(got, b)
    assert sorted(os.listdir(tmp_path)) == ["4"]


def test_manager_retention_and_maybe_save(tmp_path):
    cfg = _cfg()
    params = _init(cfg)
    with ck.CheckpointManager(tmp_path / "ck", save_interval=2,
                              max_to_keep=2) as mgr:
        assert mgr.restore_latest() is None and mgr.latest_step() is None
        saved = [s for s in range(1, 9) if mgr.maybe_save(s, params)]
        assert saved == [2, 4, 6, 8]
        assert ck.all_steps(tmp_path / "ck") == [6, 8]
        assert mgr.save(9, params, force=True)
        assert ck.all_steps(tmp_path / "ck") == [8, 9]
        mgr.wait_until_finished()
        got, step = mgr.restore_latest()
        assert step == 9
        assert_bits_equal(got, params)
    # max_to_keep None keeps every checkpoint
    keep = ck.CheckpointManager(tmp_path / "all", max_to_keep=None)
    for s in range(4):
        keep.save(s, params)
    assert ck.all_steps(tmp_path / "all") == [0, 1, 2, 3]


def test_restore_into_another_state_is_refused(tmp_path):
    """A checkpoint of an SGD run restored into a row-wise Adagrad run's
    state, or into tables of another dtype, raises; nothing is silently
    left at its initial value."""
    cfg = _cfg()
    params = _init(cfg)
    ck.save_checkpoint(tmp_path, 1, params)
    state = {"params": _init(cfg), "opt": ttrain.init_opt_state(
        params, config=cfg, optimizer="rowwise_adagrad")}
    with pytest.raises(ValueError, match="does not match"):
        ck.restore_checkpoint(tmp_path, out=state)
    bf16 = _init(_cfg(embedding_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        ck.restore_checkpoint(tmp_path, out=bf16)


# -- resume within the port ---------------------------------------------------

N = 6


def _args(optimizer, k, schedule, clip, ckpt_dir=None):
    argv = ["train", "--config", "tiny", "--device", "cpu", "--steps",
            str(N), "--optimizer", optimizer, "--update-interval", str(k)]
    if schedule:
        argv += ["--lr-schedule", "warmup_poly_decay", "--warmup-steps", "2",
                 "--decay-start", "3", "--decay-steps", "4"]
    if clip:
        argv += ["--grad-clip-norm", "0.5"]
    if ckpt_dir:
        argv += ["--ckpt-dir", str(ckpt_dir)]
    return build_parser().parse_args(argv)


def _run(v, batches, k, step):
    """The loop of ``run_training`` over ``batches`` from ``step``:
    returns (losses, step)."""
    losses = []
    for i in range(0, len(batches), k):
        chunk = batches[i:i + k]
        if k > 1:
            b = {key: torch.from_numpy(np.stack([x[key] for x in chunk]))
                 for key in KEYS}
        else:
            b = {key: torch.from_numpy(chunk[0][key]) for key in KEYS}
        if v.align is not None:
            v.align(step)
        loss, advanced = v.step(b)
        losses.append(loss.clone())
        step += advanced
    return losses, step


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("schedule", [False, True], ids=["const", "sched"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rowwise_adagrad"])
def test_resume_equals_straight_run(optimizer, k, schedule, clip, tmp_path):
    cfg = _cfg()
    rng = np.random.default_rng(11)
    batches = [random_batch(rng, cfg, 32) for _ in range(N)]
    args = _args(optimizer, k, schedule, clip)
    plan = _train_plan(args)

    straight = _build_step(args, cfg, plan, _init(cfg))
    want_losses, step = _run(straight, batches, k, 0)
    assert step == N

    mgr = ck.CheckpointManager(tmp_path, save_interval=N // 2)
    first = _build_step(args, cfg, plan, _init(cfg), mgr)
    assert first.start_step == 0
    got_losses, step = _run(first, batches[:N // 2], k, 0)
    mgr.save(step, first.payload())
    # a new process's state: other values, every one read from the file
    resumed = _build_step(args, cfg, plan, _init(cfg, seed=77), mgr)
    assert resumed.start_step == N // 2 and resumed.uses_opt == first.uses_opt
    more, step = _run(resumed, batches[N // 2:], k, resumed.start_step)
    assert step == N
    for a, b in zip(got_losses + more, want_losses):
        assert torch.equal(a, b)
    assert_bits_equal(resumed.payload(), straight.payload())
    if resumed.uses_opt:
        assert resumed.payload()["opt"]["count"] == N


# -- two-tier tables ---------------------------------------------------------

def _tiered(cfg, seed=3):
    """Tiered parameters under a budget that keeps tables 0, 2 and 4 on the
    device (6 + 9 + 40 rows of D=8) and spills 300 and 2000."""
    from dlrm_tpu_torch.parallel import host_tier as ht

    tiers = ht.plan_tiers(cfg, 55 * 8 * cfg.embedding_dtype.itemsize)
    assert tiers.host_tables == (1, 3)
    return ht.init_tiered_params(_init(cfg, seed), tiers, cfg)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rowwise_adagrad"])
@pytest.mark.parametrize("variant", ["f32", "bf16"])
def test_tiered_round_trip_every_tensor_bit_for_bit(optimizer, variant,
                                                    tmp_path, monkeypatch):
    """Two-tier parameters and optimizer state after 2 steps, written with
    a 96-byte host buffer, come back bit for bit: into the live tensors in
    place (the host tier and its accumulator filled where they lie), and
    through ``place_tiered`` / ``place_tiered_opt``."""
    from dlrm_tpu_torch.parallel import host_tier as ht

    cfg = _cfg(**({"embedding_dtype": torch.bfloat16} if variant == "bf16"
                  else {}))
    params = _tiered(cfg)
    opt = ht.init_tiered_opt_state(params, config=cfg, optimizer=optimizer)
    rng = np.random.default_rng(0)
    for _ in range(2):
        b = random_batch(rng, cfg, 32)
        ht.tiered_train_step_opt(params, opt, *(torch.from_numpy(b[k])
                                                for k in KEYS),
                                 config=cfg, optimizer=optimizer, lr=0.1)
    payload = {"params": ht.tiered_payload(params), "opt": opt}
    monkeypatch.setattr(ck, "BUFFER_BYTES", 96)
    ck.save_checkpoint(tmp_path, 2, payload)
    other = _tiered(cfg, seed=9)
    out = {"params": ht.tiered_payload(other),
           "opt": ht.init_tiered_opt_state(other, config=cfg,
                                           optimizer=optimizer)}
    filled, step = ck.restore_checkpoint(tmp_path, out=out)
    assert step == 2 and filled["params"]["emb_host"] is other["emb"].host
    assert_bits_equal(filled, payload)
    tree, _ = ck.open_checkpoint(tmp_path)
    placed = ht.place_tiered(tree["params"], params["emb"].plan, cfg, "cpu")
    assert_bits_equal(ht.tiered_payload(placed), payload["params"])
    assert_bits_equal(ht.place_tiered_opt(tree["opt"], "cpu"), opt)


@pytest.mark.parametrize("optimizer,k", [("sgd", 1), ("sgd", 3),
                                         ("rowwise_adagrad", 1),
                                         ("adagrad", 3)])
def test_tiered_resume_equals_straight_run(optimizer, k, tmp_path):
    """``train --hbm-budget-gb --ckpt-dir`` through ``_build_step``: N
    straight steps against N/2, a save, a restore into other tensors and
    N/2 more: the same loss bits and the same bits of every tensor."""
    cfg = _cfg()
    rng = np.random.default_rng(11)
    batches = [random_batch(rng, cfg, 32) for _ in range(N)]
    args = _args(optimizer, k, False, None)
    args.hbm_budget_gb = 55 * 8 * 4 / (1 << 30)
    plan = _train_plan(args)
    straight = _build_step(args, cfg, plan, _tiered(cfg))
    want_losses, _ = _run(straight, batches, k, 0)
    mgr = ck.CheckpointManager(tmp_path, save_interval=N // 2)
    first = _build_step(args, cfg, plan, _tiered(cfg), mgr)
    got_losses, step = _run(first, batches[:N // 2], k, 0)
    mgr.save(step, first.payload())
    resumed = _build_step(args, cfg, plan, _tiered(cfg, seed=77), mgr)
    assert resumed.start_step == N // 2
    more, _ = _run(resumed, batches[N // 2:], k, resumed.start_step)
    for a, b in zip(got_losses + more, want_losses):
        assert torch.equal(a, b)
    assert_bits_equal(resumed.payload(), straight.payload())
