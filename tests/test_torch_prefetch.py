"""``dlrm_tpu_torch.data.prefetch`` on the CPU.  The pipeline that feeds the
GPU (``_ahead``, here with identity transfers): the source's order and
contents, its exception raised at the consumer, at most ``size`` batches
pulled ahead of the consumer, the thread stopped when the consumer lets go.
``device_prefetch``: ``size < 1`` refused, CPU batches passed through; and
``run_training`` through it: ``--prefetch 2`` gives the losses of
``--prefetch 1`` and of the JAX package's ``train --prefetch 2`` from the
same parameters."""

import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

import dlrm_tpu
from dlrm_tpu import run as jrun
from dlrm_tpu_torch.data.prefetch import _ahead, device_prefetch
from dlrm_tpu_torch.io.convert import params_from_numpy
from dlrm_tpu_torch.run import _build_config, build_parser, run_training
from test_torch_model import jax_config, jax_params_to_numpy
from test_torch_predict import TABLES, _write_dac

CPU = torch.device("cpu")


def _batches(n, rng):
    return [{"dense": rng.normal(size=(4, 13)).astype(np.float32),
             "sparse": rng.integers(0, 9, size=(4, 26)).astype(np.int32),
             "labels": np.full(4, i, np.float32)} for i in range(n)]


class _Counting:
    """A source that counts the batches pulled from it."""

    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at = batches, fail_at
        self.pulled = 0

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.fail_at:
                raise KeyError(f"source broke at {i}")
            self.pulled += 1
            yield b


def _same(x):
    return x


def _wait_for(cond, timeout=5.0):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.005)
    return cond()


@pytest.mark.parametrize("size", [1, 2, 5])
def test_order_and_contents(size, rng):
    batches = _batches(9, rng)
    got = list(_ahead(iter(batches), size, _same, _same))
    assert len(got) == len(batches)
    for g, w in zip(got, batches):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_source_exception_reaches_the_consumer(rng):
    src = _Counting(_batches(6, rng), fail_at=3)
    it = _ahead(src, 2, _same, _same)
    got = [next(it) for _ in range(3)]
    assert [float(b["labels"][0]) for b in got] == [0.0, 1.0, 2.0]
    with pytest.raises(KeyError, match="source broke at 3"):
        next(it)


@pytest.mark.parametrize("size", [0, -1])
def test_size_below_one_is_refused(size):
    with pytest.raises(ValueError, match="prefetch size must be >= 1"):
        device_prefetch(iter([]), size=size, device="cpu")


def test_cpu_batches_pass_through(rng):
    batches = _batches(3, rng)
    got = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert all(g is b for g, b in zip(got, batches)) and len(got) == 3


@pytest.mark.parametrize("size", [1, 3])
def test_at_most_size_batches_ahead(size, rng):
    src = _Counting(_batches(10, rng))
    it = _ahead(src, size, _same, _same)
    for taken in range(1, 8):
        next(it)
        # the thread runs up to `size` ahead of what the consumer took,
        # and no further
        assert _wait_for(lambda: src.pulled == taken + size)
        time.sleep(0.02)
        assert src.pulled == taken + size
    assert len(list(it)) == 3


def test_thread_stops_when_the_consumer_lets_go(rng):
    src = _Counting(_batches(50, rng))
    before = sum(t.name == "dlrm-prefetch" for t in threading.enumerate())
    it = _ahead(src, 2, _same, _same)
    next(it)
    assert _wait_for(lambda: src.pulled == 3)
    it.close()
    assert _wait_for(lambda: sum(t.name == "dlrm-prefetch"
                                 for t in threading.enumerate()) == before)
    assert src.pulled == 3


def _train_args(data, prefetch, extra=()):
    return ["train", "--config", "tiny", "--table-sizes",
            ",".join(map(str, TABLES)), "--batch-size", "32", "--data", data,
            "--steps", "6", "--prefetch", str(prefetch), *extra]


@pytest.mark.parametrize("extra", [(), ("--update-interval", "4")],
                         ids=["steps", "blocks"])
def test_run_training_prefetch_matches_jax_train(extra, tmp_path, rng,
                                                 capsys):
    """--prefetch 2 against --prefetch 1 (equal bits) and against the JAX
    package's train --prefetch 2 from the same parameters (1e-5)."""
    data = str(tmp_path / "d.bin")
    _write_dac(data, 150, rng)
    finals = []
    for prefetch in (2, 1):
        args = build_parser().parse_args(
            _train_args(data, prefetch, extra) + ["--device", "cpu"])
        config = _build_config(args, CPU)
        jcfg = jax_config(config)
        params = params_from_numpy(jax_params_to_numpy(
            dlrm_tpu.init_params(jax.random.key(config.seed), jcfg), jcfg),
            config)
        finals.append(run_training(args, config, params)["final_loss"])
    assert finals[0] == finals[1]
    # one device (the JAX CLI shards blocks over the 8 CPU devices else)
    assert jrun.main(_train_args(data, 2, extra) + ["--sharded", "false"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 6
    assert abs(line["final_loss"] - finals[0]) <= 1e-5
