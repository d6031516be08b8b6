"""``python -m dlrm_tpu_torch train`` with optimizers, clipping, blocks and
evaluation, and ``eval``: each run's line against the same run made in
process through the library (the same seeds give the same numbers on the
CPU), the step each flag combination selects, and the flags still refused.
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
    ("--ckpt-dir", "x", "item 3, 'Checkpoints"),
    ("--hdf5", "x.h5", "item 1, 'Data, HDF5 interop"),
    ("--quantize-tables", "int8", "item 2, 'Int8 serving"),
    ("--distributed", None, "item 5, 'Multi-GPU'"),
    ("--platform", "cpu", "pass --device"),
])
def test_eval_flags_not_served_yet(flag, value, msg):
    with pytest.raises(SystemExit, match=msg):
        main(["eval", "--config", "tiny", "--device", "cpu", "--params", "p",
              flag] + ([value] if value else []))


def test_eval_needs_params():
    with pytest.raises(SystemExit, match="eval needs --params"):
        main(["eval", "--config", "tiny", "--device", "cpu"])


def test_eval_parser_covers_the_jax_eval_flags():
    from dlrm_tpu.run import build_parser as jax_parser

    def flags(parser):
        sub = next(a for a in parser._actions
                   if hasattr(a, "choices") and a.choices
                   and "eval" in a.choices)
        return {a.dest for a in sub.choices["eval"]._actions} - {"help"}

    assert flags(jax_parser()) <= flags(build_parser())


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
