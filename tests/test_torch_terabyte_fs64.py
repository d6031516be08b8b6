"""The Criteo Terabyte model at fs=64 with bf16 tables, beyond the card, on
the CPU.

At full size ``terabyte_config(feature_size=64, embedding_dtype=bf16)``
under ``--hbm-budget-gb 64`` has exactly the bytes of fs=32 in f32: the
same host tables, rows and bytes, so the card draws it into the fs=32
allocations (``chip_smoke.py`` ``phase_terabyte``).  The steps run on the
scaled Terabyte model of ``test_torch_terabyte.py`` at fs=64 with bf16
tables and f32 compute (tables 0 and 19 in the host tier, as at full size),
through that file's checks:

* the port's two-tier SGD step, row-wise Adagrad step from warm
  accumulators and K=4 row-wise block against the JAX package's tiered
  steps from one JAX-initialised state: losses 1e-3, tables 1e-2, dense
  parameters 2e-3, accumulators 1e-6 (the port rounds a host row's summed
  update once, JAX each hit's rounded update), and each tier's change to
  its tables against JAX's within 1e-3 (a block 1e-2) beyond one bf16 ulp
  of a row's value for each time either side rounds it: the 1e-2 on the
  tables lies above every value of the host tier, so it is the change
  that holds the host tier's update;
* that comparison failing a doubled or dropped host-tier update;
* the same steps against the touched-rows model in its bf16 form (each
  rewrite of a row may round by one bf16 ulp), and its XOR identity exact;
* that model catching a scaled or dropped update and one flipped bit.  A
  bf16 row's step is a few ulps, so the scaled updates are doubled, where
  the f32 cases scale some by 1.1.  Under SGD the small tables' most-hit
  rows may part by one ulp a hit, as much as their value: a doubled or
  dropped update confined to them must break the bound on their change.
"""

import dataclasses

import pytest
import torch

import test_torch_terabyte as tb
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.parallel import host_tier as ht

FS, DTYPE = 64, torch.bfloat16


def test_plan_has_the_f32_fs32_plans_tiers_and_bytes():
    """Arithmetic only: at full size under 64 GiB the bf16 fs=64 plan
    keeps tables 0 and 19 on the host, 520,381,046 rows of 128 B
    (66,608,773,888 B), and the fs=32 f32 plan's device tier to the byte;
    likewise on the scaled model under its budget."""
    for sizes, budget in ((tc.TERABYTE_TABLE_SIZES, 64 * ht.GIB),
                          (tb.SCALED, tb.BUDGET)):
        plans = []
        for fs, dtype in ((32, torch.float32), (FS, DTYPE)):
            cfg = dataclasses.replace(
                tc.terabyte_config(feature_size=fs, embedding_dtype=dtype),
                table_sizes=sizes)
            plan = ht.plan_tiers(cfg, budget)
            row = fs * dtype.itemsize
            plans.append((plan.host_tables, plan.device_tables,
                          plan.host_rows, plan.device_rows,
                          plan.host_rows * row, plan.device_rows * row))
        assert plans[0] == plans[1]
        assert plans[1][0] == (0, 19)
    assert plans[0][2:] == (52_037, 125_144, 52_037 * 128, 125_144 * 128)
    cfg = tc.terabyte_config(feature_size=FS, embedding_dtype=DTYPE)
    plan = ht.plan_tiers(cfg, 64 * ht.GIB)
    assert plan.host_rows * FS * 2 == 66_608_773_888
    assert plan.device_rows * FS * 2 == 46_386_369_664


def test_scaled_config_is_bf16_at_fs64_with_f32_compute():
    cfg = tb._cfg(FS, DTYPE)
    assert (cfg.feature_size, cfg.embedding_dtype, cfg.compute_dtype,
            cfg.interaction_impl) == (FS, DTYPE, torch.float32, "fused")
    assert cfg.bottom_mlp_sizes[-1] == FS


@pytest.mark.parametrize("kind", ["sgd", "rowwise_adagrad",
                                  "rowwise_block"])
def test_tiered_steps_match_jax(kind):
    tb.check_tiered_steps(kind, FS, DTYPE)


@pytest.mark.parametrize("factor", [2.0, 0.0])
@pytest.mark.parametrize("kind", ["sgd", "rowwise_adagrad",
                                  "rowwise_block"])
def test_jax_comparison_catches_a_wrong_host_update(monkeypatch, kind,
                                                    factor):
    tb.check_jax_catches_a_wrong_host_update(monkeypatch, kind, factor, FS,
                                             DTYPE)


@pytest.mark.parametrize("kind", ["sgd", "rowwise_adagrad",
                                  "rowwise_block"])
def test_touched_rows_model_matches_the_tiered_step(kind):
    tb.check_touched_rows_model(kind, FS, DTYPE)


@pytest.mark.parametrize("kind,key,factor", [
    (kind, key, 2.0 if factor else factor)
    for kind, key, factor in tb.WRONG_UPDATES])
def test_touched_rows_check_catches_a_wrong_update(monkeypatch, kind, key,
                                                   factor):
    tb.check_catches_a_wrong_update(monkeypatch, kind, key, factor, FS,
                                    DTYPE)


@pytest.mark.parametrize("factor", [2.0, 0.0])
def test_touched_rows_check_catches_a_wrong_hot_update(monkeypatch,
                                                       factor):
    tb.check_catches_a_wrong_hot_update(monkeypatch, factor, FS, DTYPE)


@pytest.mark.parametrize("tensor", ["tables", "accumulators"])
@pytest.mark.parametrize("tier", ["device", "host"])
def test_xor_identity_catches_one_flipped_bit(tier, tensor):
    tb.check_flipped_bit(tier, tensor, FS, DTYPE)


def test_draw_into_the_fs32_tiers_gives_the_fresh_draws_bits():
    """The bf16 fs=64 model drawn with ``out=`` into the fs=32 f32 tiers
    viewed as bf16 (the card's reuse of its allocations): the bits of a
    fresh draw from the same seed, in the same storage; tiers of another
    dtype or shape are refused."""
    cfg32, cfg64 = tb._cfg(), tb._cfg(FS, DTYPE)
    plan32, plan64 = (ht.plan_tiers(c, tb.BUDGET) for c in (cfg32, cfg64))
    old = ht.draw_tiered_params(torch.Generator().manual_seed(1), plan32,
                                cfg32)["emb"]
    views = ht.TieredEmb(old.dev.view(DTYPE), old.host.view(DTYPE), plan64)
    got = ht.draw_tiered_params(torch.Generator().manual_seed(5), plan64,
                                cfg64, out=views)
    want = ht.draw_tiered_params(torch.Generator().manual_seed(5), plan64,
                                 cfg64)
    emb = got["emb"]
    assert emb.dev.data_ptr() == old.dev.data_ptr()
    assert emb.host.data_ptr() == old.host.data_ptr()
    assert torch.equal(emb.dev, want["emb"].dev)
    assert torch.equal(emb.host, want["emb"].host)
    for part in ("bottom", "top"):
        for a, b in zip(got[part], want[part]):
            assert all(torch.equal(a[k], b[k]) for k in ("w", "b"))
    with pytest.raises(ValueError):
        ht.draw_tiered_params(torch.Generator(), plan64, cfg64, out=old)
    with pytest.raises(ValueError):
        ht.draw_tiered_params(torch.Generator(), plan32, cfg32, out=views)


def test_a_view_of_the_registered_tier_keeps_one_registration(monkeypatch):
    """The host tier for a CUDA device viewed as bf16 at twice the width:
    no second registration, and the one unregistration runs when the last
    view dies, not when the f32 tier does.  Recorded, not made: there is no
    card here."""
    import gc

    calls = []
    monkeypatch.setattr(ht, "_cuda_host_register",
                        lambda ptr, n: calls.append(("register", ptr, n)))
    monkeypatch.setattr(ht, "_cuda_host_unregister",
                        lambda ptr: calls.append(("unregister", ptr)))
    f32 = ht._host_empty((5_003, 32), torch.float32, "cuda")
    ptr, nbytes = f32.data_ptr(), 5_003 * 128
    bf16 = f32.view(DTYPE)
    assert bf16.shape == (5_003, FS) and bf16.data_ptr() == ptr
    del f32
    gc.collect()
    assert calls == [("register", ptr, nbytes)]
    bf16.fill_(1)
    del bf16
    gc.collect()
    assert calls == [("register", ptr, nbytes), ("unregister", ptr)]


def test_bf16_tables_cli_is_the_in_process_steps():
    """``train --config terabyte --feature-size 64 --bf16-tables
    --hbm-budget-gb`` on the scaled sizes, 2 row-wise steps: the host-tier
    line names tables 0 and 19, and the losses are those of the same draw
    (``draw_tiered_params`` from the config's seed) and the same 2 steps
    on the CLI's stream (seed 0) in process: the final loss within 1e-6,
    the loss lines (5 decimals) within 1e-5."""
    import contextlib
    import io
    import json

    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.run import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(["train", "--config", "terabyte", "--feature-size",
                     str(FS), "--bf16-tables", "--table-sizes",
                     ",".join(map(str, tb.SCALED)), "--interaction", "fused",
                     "--hbm-budget-gb", str(tb.BUDGET_GB), "--optimizer",
                     "rowwise_adagrad", "--lr", "0.001", "--steps", "2",
                     "--batch-size", "32", "--log-every", "1", "--device",
                     "cpu"]) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert "host-tier tables: [0, 19] (52,037 rows)" in err.getvalue()
    cfg = tb._cfg(FS, DTYPE)
    plan = ht.plan_tiers(cfg, tb.BUDGET)
    tiered = ht.draw_tiered_params(torch.Generator().manual_seed(cfg.seed),
                                   plan, cfg)
    assert tiered["emb"].host.dtype == DTYPE
    state = ht.init_tiered_opt_state(tiered, config=cfg,
                                     optimizer="rowwise_adagrad")
    losses = [float(ht.tiered_train_step_opt(
        tiered, state, *tb._t(b), config=cfg, optimizer="rowwise_adagrad",
        lr=0.001)) for b in batch_stream(cfg, 32, 2, seed=0)]
    lines = [float(ln.split()[3]) for ln in err.getvalue().splitlines()
             if ln.startswith("step ")]
    assert line["steps"] == 2
    assert abs(line["final_loss"] - losses[-1]) <= 1e-6
    assert max(abs(a - round(b, 5)) for a, b in zip(lines, losses)) <= 1e-5
