"""dlrm_tpu_torch.io.hdf5 and dlrm_tpu_torch.validation against
dlrm_tpu's: HDF5 models round-trip both ways with equal bits, the same
config, ``n_hot`` and padded top width, and the port writes the JAX
package's bytes; fixture inputs load alike (one-hot and multi-hot); and
``validate`` passes on a fixture made by the JAX package's forward and one
SGD step, fails on a perturbed or a trivial one, and its CLI prints the
JAX CLI's fields.  (The PyTorch-exported fixtures are not in this tree, so
the tests write their own.)"""

import dataclasses
import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlrm_tpu
from dlrm_tpu import run as jrun
from dlrm_tpu import validation as jvalidation
from dlrm_tpu.io import hdf5 as jh5
from dlrm_tpu.ops import embedding as jemb
from dlrm_tpu.ops.loss import bce_loss as jbce
from dlrm_tpu.train.train import train_step as jtrain_step
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.io import convert, hdf5
from dlrm_tpu_torch.run import main
from dlrm_tpu_torch.validation import validate
from test_torch_model import jax_config, jax_params_to_numpy

CFGS = {
    "onehot": tc.tiny_config(num_tables=4, rows=50),
    "multihot_padded": dataclasses.replace(
        tc.tiny_config(num_tables=3, rows=40, feature_size=16, n_hot=3),
        interaction_pad_to=64),
}


def _same_tree(a, b):
    for part in ("bottom", "top"):
        assert len(a[part]) == len(b[part])
        for la, lb in zip(a[part], b[part]):
            for k in ("w", "b"):
                assert la[k].dtype == lb[k].dtype
                np.testing.assert_array_equal(la[k], lb[k])
    np.testing.assert_array_equal(a["emb"], b["emb"])


def _geometry(cfg):
    return (cfg.bottom_mlp_sizes, cfg.top_mlp_sizes, cfg.feature_size,
            cfg.table_sizes, cfg.n_hot, cfg.top_input)


@pytest.mark.parametrize("name", list(CFGS))
def test_params_round_trip_both_ways(name, tmp_path):
    cfg = CFGS[name]
    jcfg = jax_config(cfg)
    jp = dlrm_tpu.init_params(jax.random.key(1), jcfg)
    npp = jax_params_to_numpy(jp, jcfg)
    theirs, ours = str(tmp_path / "jax.h5"), str(tmp_path / "torch.h5")
    jh5.save_params(theirs, jp, jcfg)
    hdf5.save_params(ours, npp, cfg)
    with open(theirs, "rb") as a, open(ours, "rb") as b:
        assert a.read() == b.read()
    # JAX-written -> port, port-written -> JAX
    got, gcfg = hdf5.load_params(theirs)
    _same_tree(got, npp)
    assert _geometry(gcfg) == _geometry(cfg)
    jgot, jgcfg = jh5.load_params(ours)
    _same_tree(jax_params_to_numpy(jgot, jgcfg), npp)
    assert jgcfg.n_hot == cfg.n_hot and jgcfg.top_input == cfg.top_input
    # the port's round trip, and the loaded model computes
    params = convert.params_from_numpy(got, gcfg)
    assert params["emb"].shape == (cfg.total_rows, cfg.feature_size)


def test_load_params_rejects_a_narrow_top(tmp_path):
    path = str(tmp_path / "bad.h5")
    cfg = CFGS["onehot"]
    jcfg = jax_config(cfg)
    hdf5.save_params(path, jax_params_to_numpy(
        dlrm_tpu.init_params(jax.random.key(1), jcfg), jcfg), cfg)
    with h5py.File(path, "r+") as f:
        w = f["top_l.0.weight"][:]
        del f["top_l.0.weight"]
        f["top_l.0.weight"] = w[:, :5]
    with pytest.raises(ValueError, match="smaller than the interaction"):
        hdf5.load_params(path)


def _fixture(path, cfg, rng, b=12, lr=10.0):
    """A fixture in the PyTorch layout: JAX parameters, inputs grouped per
    sample, JAX's forward (``mlp_top``, ``loss``) and its weights after one
    SGD step at ``lr`` (``update_*``)."""
    jcfg = jax_config(cfg)
    jp = dlrm_tpu.init_params(jax.random.key(2), jcfg)
    dense = rng.normal(size=(b, 13)).astype(np.float32)
    shape = (b,) if cfg.n_hot == 1 else (b, cfg.n_hot)
    sparse = np.stack([rng.integers(0, n, size=shape)
                       for n in cfg.table_sizes], axis=1).astype(np.int32)
    labels = (rng.random(b) > 0.5).astype(np.float32)
    args = [jnp.asarray(x) for x in (dense, sparse, labels)]
    out = dlrm_tpu.forward(jp, *args[:2], jcfg)
    loss = jbce(out, args[2])
    new, _ = jtrain_step(jp, *args, config=jcfg, lr=lr)
    jh5.save_params(path, jp, jcfg)
    with h5py.File(path, "r+") as f:
        del f.attrs["n_hot"]  # fixtures carry none: inferred from inputs
        f["input_bot"] = dense
        f["labels"] = labels[:, None]
        for t in range(cfg.num_tables):
            f[f"input_emb_{t}"] = sparse[:, t].reshape(-1)
            f[f"update_emb_{t}"] = np.asarray(
                jemb.get_logical_table(new["emb"], jcfg, t))
        f["mlp_top"] = np.asarray(out)[:, None]
        f["loss"] = np.asarray(loss)
        for prefix, part in (("update_bot", "bottom"), ("update_top", "top")):
            for j, layer in enumerate(new[part]):
                f[f"{prefix}_{j}.weight"] = np.asarray(layer["w"]).T
                f[f"{prefix}_{j}.bias"] = np.asarray(layer["b"])
    return sparse


@pytest.mark.parametrize("name", list(CFGS))
def test_load_inputs_and_outputs_match_jax(name, tmp_path, rng):
    path = str(tmp_path / "fx.h5")
    sparse = _fixture(path, CFGS[name], rng)
    got, want = hdf5.load_inputs(path), jh5.load_inputs(path)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["sparse"], sparse)
    ref, jref = (m.load_reference_outputs(path) for m in (hdf5, jh5))
    assert ref.keys() == jref.keys() and "update_emb_0" in ref
    _, cfg = hdf5.load_params(path)
    assert cfg.n_hot == CFGS[name].n_hot  # from the input shapes


@pytest.mark.parametrize("name", list(CFGS))
def test_validate_passes_on_a_jax_fixture(name, tmp_path, rng):
    path = str(tmp_path / "fx.h5")
    _fixture(path, CFGS[name], rng)
    report = validate(path, device="cpu")
    assert report.keys() == jvalidation.validate(path).keys()
    assert all(v["ok"] for v in report.values())
    assert max(v["max_abs_err"] for v in report.values()) < 1e-5
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("key,how,match", [
    ("update_top_0.weight", "perturb", "parity failure at top.0.weight"),
    ("update_emb_1", "perturb", "parity failure at emb_1"),
    ("update_bot_1.bias", "original", "bias == updated"),
    ("update_emb_0", "original", "table 0: PyTorch original == updated"),
])
def test_validate_fails_on_a_perturbed_or_trivial_fixture(key, how, match,
                                                          tmp_path, rng):
    path = str(tmp_path / "fx.h5")
    _fixture(path, CFGS["onehot"], rng)
    with h5py.File(path, "r+") as f:
        if how == "perturb":
            v = f[key][:]
            v.flat[3] += 1e-2
        else:  # the "update" is the original: nothing would be checked
            src = {"update_bot_1.bias": "bot_l.1.bias",
                   "update_emb_0": "emb_0"}[key]
            v = f[src][:]
        del f[key]
        f[key] = v
    with pytest.raises(AssertionError, match=match):
        validate(path, device="cpu")
    with pytest.raises(AssertionError, match=match.split(":")[0]):
        jvalidation.validate(path)


def test_validate_cli_prints_the_jax_fields(tmp_path, rng, capsys):
    good, bad = str(tmp_path / "good.h5"), str(tmp_path / "bad.h5")
    _fixture(good, CFGS["multihot_padded"], rng)
    _fixture(bad, CFGS["onehot"], rng)
    with h5py.File(bad, "r+") as f:
        f["loss"][()] = f["loss"][()] + 1.0
    assert main(["validate", good, bad, "--device", "cpu"]) == 1
    ours = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert jrun.main(["validate", good, bad]) == 1
    theirs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(ours) == len(theirs) == 2
    for o, t in zip(ours, theirs):
        assert o["device"] == "cpu"
        assert set(t) <= set(o) and o["ok"] == t["ok"]
        assert o["fixture"] == t["fixture"]
    assert ours[0]["checks"] == theirs[0]["checks"]
    assert ours[0]["worst_abs_err"] < 1e-5
    assert ours[1]["error"].startswith("parity failure at loss")
