"""The comparison that decides ``correct`` fails what it must, at a size a
test run holds (the CPU dry path).  The control is the reference put in the
program's place and computed in TF32; the faults are planted in the timed
path underneath a whole run: a step that leaves its state unchanged, half
of the batch left out and the mean taken over the rest, an answer altered
where it is produced.  The limits here are the dry path's own, set from its
readings (the cells' limits are set from the card's, in ``PERF.md``)."""

import dataclasses

import pytest
import torch

from benchmark import harness, program, spec
from benchmark.entries.train import reference_readings
from benchmark import check

TRAIN = ["kaggle-fs128.train-rowwise.zipf", "terabyte-mlperf.train-rowwise.zipf"]
SERVE = "kaggle-fs128.serve-b16384.zipf"
# the dry path's readings: the program's gaps are 0-7e-5 (recovering a
# gradient from a 64-example step's change rounds more than a full step's)
TINY = {"loss_gap": 1e-5, "grad_gap": 5e-4, "change_gap": 5e-4,
        "score_gap": 1e-5}


def _run(name, seed=11, keep=None):
    cell = spec.load_cell(name)
    cell = dataclasses.replace(cell, limits={k: TINY[k] for k in cell.limits})
    return harness.run_cell(cell, seed, 0.2, False, "cpu", tiny=True,
                            keep=keep)


@pytest.mark.parametrize("name", TRAIN + [SERVE])
def test_the_program_passes(name):
    res = _run(name)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_the_tf32_control_fails_training(name):
    keep = {}
    _run(name, keep=keep)
    cell = spec.load_cell(name)
    ctl = reference_readings(cell.config, keep["dense0"], keep["ids"],
                             keep["rows0"], keep["batches"], cell.traffic,
                             "cpu", tf32=True)
    numbers = check.train_numbers(ctl, keep["ref"])
    assert not check.verdict(numbers, {k: TINY[k] for k in cell.limits}), \
        numbers


def test_the_tf32_control_fails_scoring():
    from benchmark.reference import dlrm as ref
    keep = {}
    _run(SERVE, keep=keep)
    pairs = []
    for i in keep["picked"]:
        want = ref.score(keep["dense0"], keep["rows"][i], keep["dense"][i])
        with ref.precision(True):
            pairs.append((ref.score(keep["dense0"], keep["rows"][i],
                                    keep["dense"][i]), want))
    assert check.serve_numbers(pairs)["score_gap"] > TINY["score_gap"]


def _broken_step(kind):
    real = program.train_step

    def build(model):
        v = real(model)
        step = v.step
        if kind == "unchanged":
            from dlrm_tpu_torch.models.dlrm import forward
            from dlrm_tpu_torch.ops.loss import bce_loss

            def same(b):
                with torch.no_grad():
                    p = forward(model.params, b["dense"], b["sparse"],
                                model.config)
                return bce_loss(p, b["labels"]), 1
            v.step = same
        elif kind == "half_batch":
            v.step = lambda b: step({k: x[:x.shape[0] // 2]
                                     for k, x in b.items()})
        elif kind == "answer_altered":
            def altered(b):
                loss, n = step(b)
                return loss * (1 + 1e-3), n
            v.step = altered
        return v
    return build


@pytest.mark.parametrize("kind", ["unchanged", "half_batch",
                                  "answer_altered"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_training_step_is_not_correct(monkeypatch, name, kind):
    monkeypatch.setattr(program, "train_step", _broken_step(kind))
    res = _run(name)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("kind", ["half_batch", "answer_altered"])
def test_broken_scoring_is_not_correct(monkeypatch, kind):
    real = program.score_batch

    def broken(model, batch, device):
        s = real(model, batch, device)
        if kind == "half_batch":
            return s[:s.shape[0] // 2]
        s = s.copy()
        s[3] += 1e-3
        return s
    monkeypatch.setattr(program, "score_batch", broken)
    res = _run(SERVE)
    assert res["correct"] is False, res["checks"]
