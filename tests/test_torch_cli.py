"""``python -m dlrm_tpu_torch train`` with optimizers, clipping, blocks and
evaluation, and ``eval``: each run's line against the same run made in
process through the library (the same seeds give the same numbers on the
CPU), the step each flag combination selects, and the flags still refused.

Checkpoints, ``export``, ``instrument``, ``bench`` and ``--profile-dir``
against the JAX package's CLI: both resume from a step-0 checkpoint that
holds the same JAX-initialised parameters (and warm accumulators), so the
two runs start from one state; weights and losses within 1e-5,
accumulators within 1e-6.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dlrm_tpu_torch
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.data.criteo import DACLoader, load
from dlrm_tpu_torch.data.synthetic import ClickthroughModel, batch_stream
from dlrm_tpu_torch.io import convert
from dlrm_tpu_torch.parallel.host_tier import plan_tiers
from dlrm_tpu_torch.run import _block_iter, _crossed, build_parser, main
from dlrm_tpu_torch.train import train as ttrain
from dlrm_tpu_torch.train.metrics import evaluate
from dlrm_tpu_torch.train.optim import make_schedule
from test_torch_predict import TABLES, _write_dac

REPO = Path(__file__).resolve().parent.parent
KEYS = ("dense", "sparse", "labels")
TINY26 = ["--config", "tiny", "--table-sizes", ",".join(map(str, TABLES)),
          "--device", "cpu", "--batch-size", "32"]


def _cfg(**kw):
    return dataclasses.replace(tc.tiny_config(), table_sizes=TABLES, **kw)


def _line(capsys, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _init(cfg):
    return dlrm_tpu_torch.init_params(
        torch.Generator().manual_seed(cfg.seed), cfg)


def _stack(batches):
    return [torch.from_numpy(np.stack([b[k] for b in batches]))
            for k in KEYS]


def _synthetic_eval(params, cfg, steps=10, synthetic="uniform"):
    data = (ClickthroughModel(cfg, seed=12345).stream(32, steps, 10_001)
            if synthetic == "skewed" else batch_stream(cfg, 32, steps, 10_000))
    return evaluate(params, data, cfg)


def test_train_adagrad_blocks_clip_eval_reproduces_in_process(capsys):
    """7 steps in blocks of 2 (the last block is a remainder of 1), with
    evaluation at every crossing of a multiple of 2 and at the end."""
    line = _line(capsys, [
        "train", *TINY26, "--steps", "7", "--optimizer", "adagrad",
        "--update-interval", "2", "--grad-clip-norm", "1", "--eval-every",
        "2", "--eval-after", "--log-every", "3", "--synthetic", "skewed"])
    assert set(line) == {"steps", "final_loss", "seconds", "eval_record",
                         "eval", "device"}
    assert line["steps"] == 7 and line["device"] == "cpu"

    cfg = _cfg()
    params = _init(cfg)
    opt = ttrain.init_opt_state(params, config=cfg, optimizer="adagrad")
    block = ttrain.make_train_block_opt(cfg, optimizer="adagrad", lr=0.1,
                                        grad_clip_norm=1.0)
    data = list(ClickthroughModel(cfg, seed=12345).stream(32, 7, seed=1))
    record, step = [], 0
    for i in range(0, 7, 2):
        losses = block(params, opt, *_stack(data[i:i + 2]))
        step += len(losses)
        if step % 2 == 0:
            record.append({**_synthetic_eval(params, cfg, synthetic="skewed"),
                           "step": step})
    assert opt["count"] == 7
    assert line["final_loss"] == float(losses[-1])
    assert line["eval_record"] == record and len(record) == 3
    assert line["eval"] == _synthetic_eval(params, cfg, synthetic="skewed")
    assert line["eval"]["examples"] == 320  # 10 synthetic batches


def test_train_sgd_clip_takes_the_opt_step_and_eval_data(tmp_path, rng,
                                                         capsys):
    """SGD with a clip at K=1 runs ``train_step_opt``; ``--eval-data``
    alone evaluates at the end, over every row of the file."""
    data, ev = str(tmp_path / "d.bin"), str(tmp_path / "e.bin")
    _write_dac(data, 200, rng)
    _write_dac(ev, 75, rng)
    line = _line(capsys, ["train", *TINY26, "--data", data, "--eval-data",
                          ev, "--grad-clip-norm", "0.05", "--lr", "0.5"])
    assert "eval_record" not in line and line["steps"] == 200 // 32
    cfg = _cfg()
    params = _init(cfg)
    opt = ttrain.init_opt_state(params, config=cfg, optimizer="sgd")
    for b in DACLoader(load(data), 32):
        loss = dlrm_tpu_torch.train_step_opt(
            params, opt, *(torch.from_numpy(b[k]) for k in KEYS), config=cfg,
            optimizer="sgd", lr=0.5, grad_clip_norm=0.05)
    assert line["final_loss"] == float(loss)
    want = evaluate(params, DACLoader(load(ev), 32, drop_remainder=False),
                    cfg)
    assert line["eval"] == want and want["examples"] == 75


def test_train_scheduled_sgd_blocks_stay_on_the_schedule(capsys):
    sched = {"schedule": "warmup_poly_decay", "warmup_steps": 2,
             "decay_start": 3, "decay_steps": 4}
    line = _line(capsys, [
        "train", *TINY26, "--steps", "6", "--update-interval", "3",
        "--lr-schedule", "warmup_poly_decay", "--warmup-steps", "2",
        "--decay-start", "3", "--decay-steps", "4", "--eval-after",
        "--eval-steps", "2"])
    cfg = _cfg()
    params = _init(cfg)
    block = ttrain.make_train_block(cfg, make_schedule(0.1, **sched))
    data = list(batch_stream(cfg, 32, 6, 0))
    for i in (0, 3):
        losses = block(params, *_stack(data[i:i + 3]))
    assert block.step == 6 and line["final_loss"] == float(losses[-1])
    assert line["eval"] == _synthetic_eval(params, cfg, steps=2)


@pytest.mark.parametrize("impl", ["hybrid", "hybrid:150", "dedup", "dense_g"])
@pytest.mark.parametrize("block", [1, 2])
def test_every_adagrad_impl_runs_the_one_implementation(impl, block, capsys):
    flags = ["train", *TINY26, "--steps", "4", "--optimizer",
             "rowwise_adagrad", "--update-interval", str(block)]
    want = _line(capsys, flags)
    got = _line(capsys, [*flags, "--adagrad-impl", impl, "--block-scan"])
    assert got["final_loss"] == want["final_loss"]


@pytest.mark.parametrize("flags,msg", [
    (["--optimizer", "adam"], "--optimizer 'adam'"),
    (["--adagrad-impl", "sorted"], "--adagrad-impl 'sorted'"),
    (["--optimizer", "adagrad", "--adagrad-impl", "hybrid:x"],
     "--adagrad-impl 'hybrid:x'"),
])
def test_train_rejects_unknown_optimizer_values(flags, msg):
    with pytest.raises(SystemExit, match=msg):
        main(["train", *TINY26, "--steps", "2", *flags])


def test_eval_params_matches_evaluate_in_process(tmp_path, rng, capsys):
    cfg = _cfg(interaction_impl="fused")
    params = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(3), cfg)
    data, pz = str(tmp_path / "d.bin"), str(tmp_path / "p.npz")
    _write_dac(data, 150, rng)
    convert.save_npz(pz, convert.params_to_numpy(params))
    line = _line(capsys, ["eval", *TINY26, "--interaction", "fused",
                          "--data", data, "--params", pz, "--batch-size",
                          "64"])
    want = evaluate(params, DACLoader(load(data), 64, drop_remainder=False),
                    cfg)
    assert line == {**want, "device": "cpu"} and line["examples"] == 150
    # bounded by --eval-steps; without --data: 10 synthetic batches
    line = _line(capsys, ["eval", *TINY26, "--interaction", "fused",
                          "--data", data, "--params", pz, "--eval-steps",
                          "1"])
    assert line["examples"] == 32
    line = _line(capsys, ["eval", *TINY26, "--interaction", "fused",
                          "--params", pz])
    assert line == {**evaluate(params, batch_stream(cfg, 32, 10, 0), cfg),
                    "device": "cpu"}


@pytest.mark.parametrize("flag,value,msg", [
    ("--platform", "cpu", "pass --device"),
])
def test_eval_flags_not_served_yet(flag, value, msg):
    with pytest.raises(SystemExit, match=msg):
        main(["eval", "--config", "tiny", "--device", "cpu", "--params", "p",
              flag] + ([value] if value else []))


@pytest.mark.parametrize("flag", ["--exchange-dtype", "--distributed"])
def test_eval_multi_gpu_flags_serve_a_sharded_run(flag, tmp_path, capsys):
    """A sharded run's checkpoint on the mesh: ``--distributed`` (a gang of
    one joined through a file store) gives the metrics of ``--sharded
    true``; ``--exchange-dtype bf16`` rounds the pooled rows once, which
    moves the loss by less than 1e-3."""
    import torch.distributed as dist

    d = str(tmp_path / "ck")
    _line(capsys, ["train", *TINY26, "--steps", "2", "--sharded", "true",
                   "--max-rows-per-shard", "1000", "--col-sharded-tables",
                   "1", "--ckpt-dir", d])
    base = ["eval", *TINY26, "--ckpt-dir", d]
    want = _line(capsys, [*base, "--sharded", "true"])
    if flag == "--distributed":
        got = _line(capsys, [*base, "--distributed", "--coordinator",
                             f"file://{tmp_path / 'store'}",
                             "--num-processes", "1", "--process-id", "0"])
        assert got == want
    else:
        got = _line(capsys, [*base, "--sharded", "true", "--exchange-dtype",
                             "bf16"])
        assert got["examples"] == want["examples"] == 320
        assert abs(got["loss"] - want["loss"]) <= 1e-3
    assert not dist.is_initialized()


@pytest.mark.parametrize("flag", ["--hdf5", "--quantize-tables",
                                  "--validate-data"])
def test_eval_flags_now_served(flag, tmp_path, rng, capsys):
    """--hdf5, --quantize-tables int8 and --validate-data: the metrics of
    evaluate on the same parameters (int8: its quantization)."""
    from dlrm_tpu_torch.io import hdf5
    from dlrm_tpu_torch.ops.quant import quantize_params

    cfg = _cfg()
    params = _init(cfg)
    data, pz, h5 = (str(tmp_path / n) for n in ("d.bin", "p.npz", "m.h5"))
    _write_dac(data, 90, rng)
    convert.save_npz(pz, convert.params_to_numpy(params))
    hdf5.save_params(h5, convert.params_to_numpy(params), cfg)
    extra = {"--hdf5": ["--hdf5", h5, "--device", "cpu"],
             "--quantize-tables": TINY26 + ["--params", pz,
                                            "--quantize-tables", "int8"],
             "--validate-data": TINY26 + ["--params", pz,
                                          "--validate-data"]}[flag]
    line = _line(capsys, ["eval", "--data", data, *extra, "--batch-size",
                          "32"])
    if flag == "--quantize-tables":
        params = quantize_params(params, cfg)
    want = evaluate(params, DACLoader(load(data), 32, drop_remainder=False),
                    cfg)
    assert line == {**want, "device": "cpu"} and line["examples"] == 90


def test_eval_needs_params():
    with pytest.raises(SystemExit, match="eval needs --params .*--ckpt-dir"):
        main(["eval", "--config", "tiny", "--device", "cpu"])


def test_eval_parser_covers_the_jax_eval_flags():
    from dlrm_tpu.run import build_parser as jax_parser

    def flags(parser):
        sub = next(a for a in parser._actions
                   if hasattr(a, "choices") and a.choices
                   and "eval" in a.choices)
        return {a.dest for a in sub.choices["eval"]._actions} - {"help"}

    assert flags(jax_parser()) <= flags(build_parser())


@pytest.mark.parametrize("cmd", ["export", "instrument", "bench"])
def test_parser_covers_the_jax_flags_of_the_new_subcommands(cmd):
    from dlrm_tpu.run import build_parser as jax_parser

    def flags(parser):
        sub = next(a for a in parser._actions
                   if hasattr(a, "choices") and a.choices
                   and cmd in a.choices)
        return {a.dest: a.default for a in sub.choices[cmd]._actions
                if a.dest != "help"}

    theirs, ours = flags(jax_parser()), flags(build_parser())
    assert set(theirs) <= set(ours), set(theirs) - set(ours)
    # the same defaults (batch size, lr, steps, seed)
    assert {k: ours[k] for k in theirs} == theirs


def test_block_iter_stacks_and_keeps_the_remainder():
    src = [{"dense": np.full((4, 2), i, np.float32),
            "labels": np.full((4,), i, np.float32)} for i in range(5)]
    blocks = list(_block_iter(iter(src), 2))
    assert [b["dense"].shape for b in blocks] == [(2, 4, 2), (2, 4, 2),
                                                  (1, 4, 2)]
    assert blocks[1]["labels"][:, 0].tolist() == [2.0, 3.0]
    assert list(_block_iter(iter([]), 3)) == []
    from dlrm_tpu.run import _block_iter as jax_block_iter
    for ours, theirs in zip(blocks, jax_block_iter(iter(src), 2)):
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])


def test_crossed_matches_jax():
    from dlrm_tpu.run import _crossed as jax_crossed
    for prev, cur, every in [(0, 1, 1), (0, 4, 3), (3, 4, 3), (4, 5, 3),
                             (5, 8, 4), (0, 2, None), (0, 2, 0), (7, 8, 8)]:
        assert _crossed(prev, cur, every) == jax_crossed(prev, cur, every)


def test_module_entry_point_trains_with_the_full_recipe_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run(
        [sys.executable, "-m", "dlrm_tpu_torch", "train", "--config", "tiny",
         "--steps", "4", "--batch-size", "16", "--device", "cpu",
         "--optimizer", "adagrad", "--update-interval", "2",
         "--grad-clip-norm", "1", "--eval-every", "2", "--eval-after"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["steps"] == 4 and line["device"] == "cpu"
    assert np.isfinite(line["final_loss"])
    assert [m["step"] for m in line["eval_record"]] == [2, 4]
    assert line["eval"]["examples"] == 160
    assert "eval @ step 2" in res.stderr
    # the same run in process gives the same numbers
    cfg = tc.tiny_config()
    params = _init(cfg)
    opt = ttrain.init_opt_state(params, config=cfg, optimizer="adagrad")
    data = list(batch_stream(cfg, 16, 4, 0))
    for i in (0, 2):
        losses = ttrain.train_block_opt(
            params, opt, *_stack(data[i:i + 2]), config=cfg, lr=0.1,
            optimizer="adagrad", grad_clip_norm=1.0)
    assert line["final_loss"] == float(losses[-1])
    assert line["eval"] == evaluate(params, batch_stream(cfg, 16, 10, 10_000),
                                    cfg)


# -- checkpoints, export, instrument, bench, --profile-dir --------------------

MODEL26 = TINY26[:4]  # the model flags: config and table sizes
TRAIN26 = ["train", "--config", "tiny", "--table-sizes",
           ",".join(map(str, TABLES)), "--batch-size", "32",
           "--save-interval", "2"]


def _jax_line(capsys, argv):
    from dlrm_tpu import run as jrun

    assert jrun.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _plant_start(flags, optimizer, jdir, tdir):
    """The same step-0 checkpoint for both CLIs: JAX-initialised parameters
    and, for Adagrad, accumulators warmed to 0.01 (``ROADMAP.md`` §3);
    returns the JAX config of the flags."""
    import jax
    import jax.numpy as jnp
    import dlrm_tpu
    from dlrm_tpu import run as jrun
    from dlrm_tpu.io import checkpoint as jck
    from dlrm_tpu.train.train import init_opt_state as jinit_opt
    from dlrm_tpu_torch.io import checkpoint as ck
    from test_torch_model import jax_params_to_numpy
    from test_torch_optim import jax_opt_to_numpy

    jcfg = jrun._build_config(jrun.build_parser().parse_args(flags))
    cfg = _cfg()
    jparams = dlrm_tpu.init_params(jax.random.key(jcfg.seed), jcfg)
    params = convert.params_from_numpy(jax_params_to_numpy(jparams, jcfg),
                                       cfg)
    if optimizer == "sgd":
        jpay, tpay = jparams, params
    else:
        jopt = jax.tree.map(
            lambda a: (jnp.full_like(a, 0.01)
                       if jnp.issubdtype(a.dtype, jnp.floating) else a),
            jinit_opt(jparams, config=jcfg, optimizer=optimizer, lr=0.1))
        opt = convert.opt_state_from_numpy(
            jax_opt_to_numpy(jopt, jcfg, optimizer), cfg, optimizer)
        jpay = {"params": jparams, "opt": jopt}
        tpay = {"params": params, "opt": opt}
    with jck.CheckpointManager(jdir) as mgr:
        mgr.save(0, jpay)
    ck.save_checkpoint(tdir, 0, tpay)
    return jcfg


def _jax_ckpt_to_numpy(jdir, jcfg, optimizer):
    """The newest JAX checkpoint as (logical numpy params, numpy optimizer
    state or None, step)."""
    from types import SimpleNamespace

    from dlrm_tpu.io import checkpoint as jck
    from test_torch_model import jax_params_to_numpy
    from test_torch_optim import jax_opt_to_numpy

    payload, step = jck.restore_checkpoint(jdir)
    if optimizer == "sgd":
        return jax_params_to_numpy(payload, jcfg), None, step
    # a template-less restore gives the optax states as plain dicts
    o = payload["opt"]
    jopt = {"dense": [SimpleNamespace(**o["dense"][0])],
            "emb": SimpleNamespace(**o["emb"]), "count": o["count"]}
    return (jax_params_to_numpy(payload["params"], jcfg),
            jax_opt_to_numpy(jopt, jcfg, optimizer), step)


def _max_param_diff(tparams, np_params):
    return max([float(np.abs(tparams["emb"].numpy() - np_params["emb"]).max())]
               + [float(np.abs(layer[k].numpy() - jl[k]).max())
                  for part in ("bottom", "top")
                  for layer, jl in zip(tparams[part], np_params[part])
                  for k in ("w", "b")])


@pytest.mark.parametrize("optimizer", ["sgd", "rowwise_adagrad"])
def test_train_ckpt_resume_matches_the_jax_cli(optimizer, tmp_path, capsys):
    """``train --ckpt-dir --steps 4 --save-interval 2``, then the same with
    ``--steps 6`` (a resume: 2 more steps over the stream restarted from
    --seed), through both CLIs; ``--sharded false`` to JAX only (it shards
    over the 8 CPU devices else)."""
    from dlrm_tpu_torch.io import checkpoint as ck

    flags = [*TRAIN26, "--optimizer", optimizer]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = _plant_start(flags, optimizer, jdir, tdir)
    for steps, done in (("4", 4), ("6", 2)):
        jline = _jax_line(capsys, [*flags, "--steps", steps, "--ckpt-dir",
                                   jdir, "--sharded", "false"])
        line = _line(capsys, [*flags, "--steps", steps, "--ckpt-dir", tdir,
                              "--device", "cpu"])
        assert jline["steps"] == line["steps"] == done
        assert abs(jline["final_loss"] - line["final_loss"]) <= 1e-5
    assert ck.all_steps(tdir) == [2, 4, 6]
    want, want_opt, jstep = _jax_ckpt_to_numpy(jdir, jcfg, optimizer)
    got, step = ck.restore_checkpoint(tdir)
    assert step == jstep == 6
    if optimizer != "sgd":
        opt = convert.opt_state_to_numpy(got["opt"])
        assert opt["count"] == want_opt["count"] == 6
        assert np.abs(opt["emb"] - want_opt["emb"]).max() <= 1e-6
        assert max(np.abs(l[k] - jl[k]).max()
                   for part in ("bottom", "top")
                   for l, jl in zip(opt["dense"][part],
                                    want_opt["dense"][part])
                   for k in ("w", "b")) <= 1e-6
        got = got["params"]
    assert _max_param_diff(got, want) <= 1e-5
    metas = [json.loads(Path(d, "run_meta.json").read_text())
             for d in (jdir, tdir)]
    shared = set(metas[0]) & set(metas[1])
    assert shared == set(metas[1]) and len(shared) == 7
    assert {k: metas[0][k] for k in shared} == metas[1]


# -- two-tier runs against the JAX package's CLI ------------------------------

# 2e-6 GiB: 10 of the 26 tables on the device, 16 in the host tier
TIERED26 = [*TRAIN26, "--hbm-budget-gb", "2e-6"]


def _plant_tiered_start(flags, optimizer, jdir, tdir):
    """The same step-0 two-tier checkpoint for both CLIs: the JAX package's
    tiered parameters (and, for Adagrad, accumulators warmed to 0.01) and
    the port's conversion of them; returns (JAX config, JAX plan, the
    port's plan)."""
    import jax
    import dlrm_tpu
    from dlrm_tpu import run as jrun
    from dlrm_tpu.io import checkpoint as jck
    from dlrm_tpu.parallel import host_tier as jht
    from dlrm_tpu_torch.io import checkpoint as ck
    from dlrm_tpu_torch.parallel import host_tier as ht
    from test_torch_host_tier import _jax_opt_np, _jax_tiered_np, _warm_jax

    jargs = jrun.build_parser().parse_args(flags)
    jcfg = jrun._build_config(jargs)
    budget = int(jargs.hbm_budget_gb * (1 << 30))
    jplan, plan = jht.plan_tiers(jcfg, budget), ht.plan_tiers(_cfg(), budget)
    jparams = dlrm_tpu.init_params(jax.random.key(jcfg.seed), jcfg)
    jt = jht.init_tiered_params(jax.tree.map(np.asarray, jparams), jplan,
                                jcfg)
    tp = convert.tiered_params_from_numpy(_jax_tiered_np(jt, jplan, jcfg),
                                          plan, _cfg())
    jpay, tpay = jt, ht.tiered_payload(tp)
    if optimizer != "sgd":
        jopt = _warm_jax(jht.init_tiered_opt_state(
            jt, config=jcfg, optimizer=optimizer, lr=0.1, plan=jplan))
        topt = convert.tiered_opt_state_from_numpy(
            _jax_opt_np(jopt, jplan, jcfg, optimizer), plan, _cfg(),
            optimizer)
        jpay, tpay = {"params": jt, "opt": jopt}, {"params": tpay,
                                                    "opt": topt}
    with jck.CheckpointManager(jdir) as mgr:
        mgr.save(0, jpay)
    ck.save_checkpoint(tdir, 0, tpay)
    return jcfg, jplan, plan


def _tiered_ckpts_diff(jdir, tdir, jcfg, jplan, plan, optimizer) -> dict:
    """Max |diff| between the newest checkpoints of the two CLIs' tiered
    runs: merged tables, dense parameters, accumulators of both tiers."""
    from types import SimpleNamespace

    from dlrm_tpu.io import checkpoint as jck
    from dlrm_tpu.parallel import host_tier as jht
    from dlrm_tpu_torch.io import checkpoint as ck
    from dlrm_tpu_torch.parallel import host_tier as ht
    from test_torch_host_tier import _jax_opt_np

    jpay, jstep = jck.restore_checkpoint(jdir)
    tpay, step = ck.restore_checkpoint(tdir)
    assert step == jstep
    jp, tp = (jpay, tpay) if optimizer == "sgd" else (jpay["params"],
                                                      tpay["params"])
    got = ht.merge_tiers(tp["emb_dev"], tp["emb_host"], plan, _cfg())
    want = jht.merge_tiers(tuple(jp["emb_dev"]), np.asarray(jp["emb_host"]),
                           jplan, jcfg)
    out = {"tables": float(np.abs(got.numpy() - want).max()),
           "dense": max(float(np.abs(l[k].numpy() - np.asarray(jl[k])).max())
                        for part in ("bottom", "top")
                        for l, jl in zip(tp[part], jp[part])
                        for k in ("w", "b"))}
    if optimizer != "sgd":
        o = jpay["opt"]
        want = _jax_opt_np({**o, "dense": [SimpleNamespace(**o["dense"][0])],
                            "dev_acc": tuple(o["dev_acc"])}, jplan, jcfg,
                           optimizer)
        topt = tpay["opt"]
        assert topt["count"] == want["count"] == step
        out["accumulators"] = max(
            float(np.abs(topt["dev_acc"].numpy() - want["dev_acc"]).max()),
            float(np.abs(topt["host_acc"].numpy().reshape(-1)
                         - want["host_acc"]).max()))
    return out


@pytest.mark.parametrize("optimizer", ["sgd", "rowwise_adagrad"])
def test_train_two_tier_resume_matches_the_jax_cli(optimizer, tmp_path,
                                                    capsys):
    """``train --hbm-budget-gb --ckpt-dir --steps 4``, then ``--steps 6
    --eval-after`` (a resume), through both CLIs from one planted start:
    losses, the evaluation of the tiered parameters (JAX: its merged
    eval_view; the port: both tiers in place), tables and dense parameters
    within 1e-5, accumulators within 1e-6; ``run_meta.json`` alike."""
    flags = [*TIERED26, "--optimizer", optimizer]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg, jplan, plan = _plant_tiered_start(flags, optimizer, jdir, tdir)
    for steps, done, extra in (("4", 4, []), ("6", 2, ["--eval-after"])):
        jline = _jax_line(capsys, [*flags, "--steps", steps, "--ckpt-dir",
                                   jdir, "--sharded", "false", *extra])
        line = _line(capsys, [*flags, "--steps", steps, "--ckpt-dir", tdir,
                              "--device", "cpu", *extra])
        assert jline["steps"] == line["steps"] == done
        assert abs(jline["final_loss"] - line["final_loss"]) <= 1e-5
    ev, jev = line["eval"], jline["eval"]
    assert ev["examples"] == jev["examples"] == 320
    assert max(abs(ev[k] - jev[k]) for k in ("loss", "auc")) <= 1e-5
    assert abs(ev["accuracy"] - jev["accuracy"]) <= 1 / 320
    d = _tiered_ckpts_diff(jdir, tdir, jcfg, jplan, plan, optimizer)
    assert d["tables"] <= 1e-5 and d["dense"] <= 1e-5, d
    assert d.get("accumulators", 0) <= 1e-6, d
    metas = [json.loads(Path(x, "run_meta.json").read_text())
             for x in (jdir, tdir)]
    assert metas[1]["two_tier"] is True and metas[1]["hbm_budget_gb"] == 2e-6
    assert {k: metas[0][k] for k in metas[1]} == metas[1]


def test_eval_ckpt_dir_serves_a_two_tier_checkpoint(tmp_path, rng, capsys):
    """``eval --ckpt-dir`` on a two-tier run's checkpoint (device tier to
    the device, host tier into host memory) equals the run's own
    ``--eval-after`` and the JAX package's ``eval --ckpt-dir`` on its twin
    run; ``predict --ckpt-dir`` scores what ``place_tiered`` of it scores;
    ``export --quantize int8`` reads it merged."""
    from dlrm_tpu_torch.io import checkpoint as ck
    from dlrm_tpu_torch.ops.quant import quantize_emb_host
    from dlrm_tpu_torch.parallel import host_tier as ht
    from dlrm_tpu_torch.run import score_batch

    data = str(tmp_path / "d.bin")
    _write_dac(data, 150, rng)
    flags = [*TIERED26, "--optimizer", "adagrad"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _, _, plan = _plant_tiered_start(flags, "adagrad", jdir, tdir)
    run = ["--steps", "3", "--data", data, "--eval-after"]
    line = _line(capsys, [*flags, *run, "--ckpt-dir", tdir, "--device",
                          "cpu"])
    _jax_line(capsys, [*flags, *run, "--ckpt-dir", jdir, "--sharded",
                       "false"])
    got = _line(capsys, ["eval", *TINY26, "--data", data, "--ckpt-dir",
                         tdir])
    assert got == {**line["eval"], "device": "cpu"}
    assert got["examples"] == 150
    want = _jax_line(capsys, ["eval", *MODEL26, "--data", data,
                              "--batch-size", "32", "--ckpt-dir", jdir])
    assert max(abs(got[k] - want[k]) for k in ("loss", "auc")) <= 1e-5
    assert abs(got["accuracy"] - want["accuracy"]) <= 1 / 150
    out = str(tmp_path / "s.npy")
    _line(capsys, ["predict", *TINY26, "--data", data, "--ckpt-dir", tdir,
                   "--out", out])
    placed = ht.place_tiered(ck.open_checkpoint(tdir)[0]["params"], plan,
                             _cfg(), "cpu")
    np.testing.assert_array_equal(np.load(out), score_batch(
        placed, DACLoader(load(data), 150)[0], _cfg(), torch.device("cpu")))
    saved = ck.restore_checkpoint(tdir)[0]["params"]
    logical = ht.merge_tiers(saved["emb_dev"], saved["emb_host"], plan,
                             _cfg()).numpy()
    q = str(tmp_path / "q")
    exp = _line(capsys, ["export", *MODEL26, "--ckpt-dir", tdir, "--out", q,
                         "--quantize", "int8"])
    assert exp["table_bytes"] == ck.restore_checkpoint(q)[0]["emb_q"][
        "codes"].numel() + 4 * sum(TABLES)
    assert torch.equal(ck.restore_checkpoint(q)[0]["emb_q"]["codes"],
                       quantize_emb_host(logical, _cfg()).codes)


def test_host_prefetch_matches_the_jax_cli(tmp_path, capsys):
    """``train --hbm-budget-gb --host-prefetch`` through both CLIs from one
    planted start, 5 steps: the same final loss and tables within 1e-5."""
    flags = [*TIERED26, "--host-prefetch"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg, jplan, plan = _plant_tiered_start(flags, "sgd", jdir, tdir)
    jline = _jax_line(capsys, [*flags, "--steps", "5", "--ckpt-dir", jdir,
                               "--sharded", "false"])
    line = _line(capsys, [*flags, "--steps", "5", "--ckpt-dir", tdir,
                          "--device", "cpu"])
    assert jline["steps"] == line["steps"] == 5
    assert abs(jline["final_loss"] - line["final_loss"]) <= 1e-5
    d = _tiered_ckpts_diff(jdir, tdir, jcfg, jplan, plan, "sgd")
    assert d["tables"] <= 1e-5 and d["dense"] <= 1e-5, d


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_eval_ckpt_dir_equals_the_runs_eval_after(optimizer, tmp_path, rng,
                                                  capsys):
    data, d = str(tmp_path / "d.bin"), str(tmp_path / "ck")
    _write_dac(data, 150, rng)
    line = _line(capsys, ["train", *TINY26, "--data", data, "--eval-after",
                          "--optimizer", optimizer, "--ckpt-dir", d])
    got = _line(capsys, ["eval", *TINY26, "--data", data, "--ckpt-dir", d])
    assert got == {**line["eval"], "device": "cpu"}
    assert got["examples"] == 150


def test_serving_from_ckpt_dir_takes_the_runs_metadata(tmp_path, capsys):
    """bf16 tables come from run_meta.json; table sizes that differ from
    the run's are refused, and so is a run_meta.json that calls an
    unsharded checkpoint sharded; a sharded run's checkpoint serves, its
    tables unsharded onto the device."""
    from dlrm_tpu_torch.io import checkpoint as ck

    d = str(tmp_path / "ck")
    _line(capsys, ["train", *TINY26, "--steps", "2", "--bf16-tables",
                   "--ckpt-dir", d])
    got = _line(capsys, ["eval", *TINY26, "--ckpt-dir", d])
    params, _ = ck.restore_checkpoint(d)
    cfg = _cfg(embedding_dtype=torch.bfloat16)
    assert params["emb"].dtype == torch.bfloat16
    assert got == {**evaluate(params, batch_stream(cfg, 32, 10, 0), cfg),
                   "device": "cpu"}
    with pytest.raises(SystemExit, match="trained with table sizes"):
        main(["eval", "--config", "tiny", "--device", "cpu", "--ckpt-dir",
              d])
    meta_path = Path(d, "run_meta.json")
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps({**meta, "sharded": True}))
    with pytest.raises(SystemExit, match="holds no placement"):
        main(["eval", *TINY26, "--ckpt-dir", d])
    d2 = str(tmp_path / "sharded")
    _line(capsys, ["train", *TINY26, "--steps", "2", "--bf16-tables",
                   "--sharded", "true", "--ckpt-dir", d2])
    got = _line(capsys, ["eval", *TINY26, "--ckpt-dir", d2])
    sh, _ = ck.restore_checkpoint(d2)
    from dlrm_tpu_torch.parallel import embedding as pemb
    from dlrm_tpu_torch.parallel.placement import plan_placement
    p = plan_placement(**ck.checkpoint_placement(d2))
    params = {"bottom": sh["bottom"], "top": sh["top"],
              "emb": pemb.unshard_tables(sh["emb"], p, cfg)}
    assert params["emb"].dtype == torch.bfloat16
    assert got == {**evaluate(params, batch_stream(cfg, 32, 10, 0), cfg),
                   "device": "cpu"}


def test_export_hdf5_loads_through_the_jax_package(tmp_path, capsys):
    from dlrm_tpu.io import hdf5 as jhdf5
    from dlrm_tpu_torch.io import checkpoint as ck
    from test_torch_model import jax_params_to_numpy

    d, out = str(tmp_path / "ck"), str(tmp_path / "m.h5")
    _line(capsys, ["train", *TINY26, "--steps", "3", "--optimizer",
                   "rowwise_adagrad", "--ckpt-dir", d])
    line = _line(capsys, ["export", *MODEL26, "--ckpt-dir", d, "--out", out])
    assert line == {"out": out, "tables": 26, "total_rows": sum(TABLES),
                    "bytes": os.path.getsize(out)}
    jparams, jcfg = jhdf5.load_params(out)
    assert jcfg.table_sizes == TABLES
    want = convert.params_to_numpy(ck.restore_checkpoint(d)[0]["params"])
    got = jax_params_to_numpy(jparams, jcfg)
    np.testing.assert_array_equal(got["emb"], want["emb"])
    for part in ("bottom", "top"):
        for a, b in zip(got[part], want[part]):
            for k in ("w", "b"):
                np.testing.assert_array_equal(a[k], b[k])
    # the port reads its own export back: the same bits
    line = _line(capsys, ["export", "--hdf5", out, "--out",
                          str(tmp_path / "again.h5")])
    assert Path(out).read_bytes() == (tmp_path / "again.h5").read_bytes()


def test_export_int8_artifact_serves_as_quantize_tables(tmp_path, rng,
                                                        capsys):
    """``export --quantize int8`` then ``predict --ckpt-dir`` of the
    artifact gives the bits of ``predict --ckpt-dir --quantize-tables
    int8`` on the training checkpoint; so does ``eval``."""
    from dlrm_tpu_torch.io import checkpoint as ck
    from dlrm_tpu_torch.ops.quant import quantize_emb_host, table_bytes

    data, d, q = (str(tmp_path / n) for n in ("d.bin", "ck", "q"))
    _write_dac(data, 90, rng)
    _line(capsys, ["train", *TINY26, "--steps", "3", "--ckpt-dir", d])
    line = _line(capsys, ["export", *MODEL26, "--ckpt-dir", d, "--out", q,
                          "--quantize", "int8"])
    cfg = _cfg()
    params, _ = ck.restore_checkpoint(d)
    qemb = quantize_emb_host(params["emb"].numpy(), cfg)
    assert line == {"out": q, "tables": 26, "total_rows": sum(TABLES),
                    "table_bytes": table_bytes(qemb), "quantized": "int8"}
    art, _ = ck.restore_checkpoint(q)
    assert torch.equal(art["emb_q"]["codes"], qemb.codes)
    assert torch.equal(art["emb_q"]["scales"], qemb.scales)
    assert json.loads(Path(q, "run_meta.json").read_text())["quantized"] \
        == "int8"
    scores = []
    for src in (["--ckpt-dir", q], ["--ckpt-dir", d, "--quantize-tables",
                                    "int8"]):
        out = str(tmp_path / f"s{len(scores)}.npy")
        _line(capsys, ["predict", *TINY26, "--data", data, "--out", out,
                       *src])
        scores.append(np.load(out))
    np.testing.assert_array_equal(scores[0], scores[1])
    evals = [_line(capsys, ["eval", *TINY26, "--data", data, *src])
             for src in (["--ckpt-dir", q],
                         ["--ckpt-dir", d, "--quantize-tables", "int8"])]
    assert evals[0] == evals[1]
    with pytest.raises(SystemExit, match="already an int8"):
        main(["export", *MODEL26, "--ckpt-dir", q, "--out",
              str(tmp_path / "x.h5")])


def test_instrument_and_bench_print_the_jax_keys(capsys):
    small = ["--config", "tiny", "--batch-size", "64", "--steps", "2"]
    for cmd in ("instrument", "bench"):
        want = _jax_line(capsys, [cmd, *small])
        got = _line(capsys, [cmd, *small, "--device", "cpu"])
        assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
        if cmd == "instrument":
            assert set(got["phase_ms"]) == set(want["phase_ms"])
            assert np.isfinite(got["loss"])
        else:
            assert got["step_ms"] > 0 and got["examples_per_s"] > 0


def test_train_profile_dir_writes_a_trace_of_the_phase_scopes(tmp_path):
    prof = tmp_path / "prof"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run(
        [sys.executable, "-m", "dlrm_tpu_torch", "train", "--config", "tiny",
         "--steps", "8", "--batch-size", "16", "--device", "cpu",
         "--profile-dir", str(prof)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "profile written" in res.stderr
    (trace,) = prof.glob("*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"lookup", "bottom_mlp", "interaction", "top_mlp"} <= names


def test_train_profile_dir_trace_holds_the_counters(tmp_path):
    """A two-tier ``train --profile-dir`` run: the Chrome trace of steps
    3-5 holds the program's counters of those steps (reset at the trace's
    start) under ``counters``, beside the step's spans."""
    prof = tmp_path / "prof"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run(
        [sys.executable, "-m", "dlrm_tpu_torch", *TIERED26[:-2],
         "--hbm-budget-gb", "2e-6", "--steps", "8", "--device", "cpu",
         "--profile-dir", str(prof)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    (trace,) = prof.glob("*.json")
    doc = json.loads(trace.read_text())
    counters = doc["counters"]
    cfg = _cfg()
    plan = plan_tiers(cfg, int(2e-6 * (1 << 30)))
    row = cfg.feature_size * 4
    # SGD: every hit's host row gathered, each distinct one read and
    # written back once, in three traced steps of 32 examples
    assert counters["host_tier.gather_bytes"] == \
        3 * 32 * len(plan.host_tables) * row
    upd = counters["host_tier.update_bytes"]
    assert upd % (2 * row) == 0 and 0 < upd <= \
        2 * counters["host_tier.gather_bytes"]
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"dedup", "dense_apply", "sparse_update", "top_mlp.bwd",
            "host_tier_update"} <= names
