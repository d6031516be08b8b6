"""dlrm_tpu_torch's data sources against dlrm_tpu's: ``ClickthroughModel``
batches and ``DACLoader``'s epoch shuffles are bit-identical for the same
seed and epoch (both marshal with numpy)."""

import dataclasses

import numpy as np
import pytest

from dlrm_tpu.data import synthetic as jsyn
from dlrm_tpu.data.criteo import DACLoader as JaxDACLoader
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.data import criteo as tcriteo
from dlrm_tpu_torch.data.synthetic import ClickthroughModel
from test_torch_model import jax_config
from test_torch_predict import _write_dac


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("n_hot", [1, 3])
def test_clickthrough_model_matches_jax(n_hot):
    cfg = dataclasses.replace(tc.tiny_config(num_tables=5, rows=500),
                              n_hot=n_hot)
    ours = ClickthroughModel(cfg, seed=12345)
    theirs = jsyn.ClickthroughModel(jax_config(cfg), seed=12345)
    got = list(ours.stream(64, 4, seed=1))
    _assert_same_batches(got, list(theirs.stream(64, 4, seed=1)))
    # Zipf ids repeat within a batch; labels carry the planted signal
    ids = got[0]["sparse"][:, 0].reshape(-1)
    assert len(np.unique(ids)) < len(ids)
    assert set(np.unique(got[0]["labels"])) == {0.0, 1.0}


@pytest.mark.parametrize("kw", [
    {},
    {"shuffle": True},
    {"shuffle": True, "seed": 3},
    {"shuffle_rows": True},
    {"shuffle_rows": True, "shuffle_window": 3, "seed": 5},
    {"shuffle_rows": True, "drop_remainder": False},
])
def test_dac_loader_shuffles_match_jax(kw, tmp_path, rng):
    """Three epochs: each draws its order from (seed, epoch)."""
    path = str(tmp_path / "d.bin")
    _write_dac(path, 700, rng)
    data = tcriteo.load(path)
    ours = tcriteo.DACLoader(data, 64, **kw)
    theirs = JaxDACLoader(data, 64, use_native=False, **kw)
    epochs = [list(ours) for _ in range(3)]
    for got in epochs:
        _assert_same_batches(got, list(theirs))
    if kw.get("shuffle") or kw.get("shuffle_rows"):
        assert not all(np.array_equal(a["labels"], b["labels"])
                       for a, b in zip(epochs[0], epochs[1]))
    # every row once per epoch, the ragged tail only when kept
    rows = np.concatenate([b["dense"] for b in epochs[0]])
    want = 700 if kw.get("drop_remainder") is False else 640
    assert rows.shape[0] == want
    assert len(np.unique(rows, axis=0)) == want


def test_dac_loader_epoch_advances_when_iteration_starts(tmp_path, rng):
    """A consumer that stops mid-epoch and iterates again gets the next
    epoch's order, as with the JAX loader."""
    path = str(tmp_path / "d.bin")
    _write_dac(path, 640, rng)
    data = tcriteo.load(path)
    for kw in ({"shuffle": True}, {"shuffle_rows": True}):
        ours = tcriteo.DACLoader(data, 64, seed=2, **kw)
        theirs = JaxDACLoader(data, 64, seed=2, use_native=False, **kw)
        next(iter(ours)), next(iter(theirs))
        _assert_same_batches(list(ours), list(theirs))


def test_dac_loader_indexing_ignores_shuffle(tmp_path, rng):
    path = str(tmp_path / "d.bin")
    _write_dac(path, 200, rng)
    data = tcriteo.load(path)
    plain = tcriteo.DACLoader(data, 64)
    shuffled = tcriteo.DACLoader(data, 64, shuffle_rows=True)
    for i in range(len(plain)):
        _assert_same_batches([shuffled[i]], [plain[i]])
