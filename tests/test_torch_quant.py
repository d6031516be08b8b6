"""dlrm_tpu_torch.ops.quant against dlrm_tpu.ops.quant: int8 codes and
scales equal bit for bit (on the device and on the host, from lane-packed
and plain JAX storage, f32 and bf16 tables, all-zero rows), the quantized
lookup and forward within 1e-6, scores within 5e-3 of f32, the footprint,
the storage guards, training refused; and ``predict`` / ``eval`` with
``--quantize-tables int8`` and ``--hdf5`` against the JAX CLI."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import dlrm_tpu
from dlrm_tpu import run as jrun
from dlrm_tpu.io import hdf5 as jh5
from dlrm_tpu.ops import embedding as jemb
from dlrm_tpu.ops import quant as jquant
import dlrm_tpu_torch
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.io import convert
from dlrm_tpu_torch.ops import quant
from dlrm_tpu_torch.run import main
from dlrm_tpu_torch.train import train as ttrain
from test_torch_model import jax_config, jax_params_to_numpy
from test_torch_predict import TABLES, _write_dac


def _cfg(name, **kw):
    """Port configs, each with the JAX storage it is held against."""
    if name == "packed16":  # pack 8, several chunks, ragged tables
        cfg = dataclasses.replace(
            tc.tiny_config(feature_size=16), table_sizes=(5, 300, 17, 2000,
                                                          3, 60, 9, 700),
            small_table_threshold=100, **kw)
        return cfg, {"chunk_budget_bytes": 32 << 10}
    if name == "chunked128":  # pack 1, several chunks
        cfg = dataclasses.replace(
            tc.tiny_config(feature_size=128), table_sizes=(50, 700, 3, 130),
            small_table_threshold=60, **kw)
        return cfg, {"chunk_budget_bytes": 128 << 10}
    cfg = dataclasses.replace(  # plain (total_rows, 128) stack
        tc.tiny_config(feature_size=128), table_sizes=(40, 9, 300),
        small_table_threshold=20, **kw)
    return cfg, {"packed_tables": False}


def _jax(cfg, storage):
    return dataclasses.replace(jax_config(cfg), **storage)


def _placement(jcfg):
    if jcfg.is_packed:
        return list(zip(jcfg.table_chunk, jcfg.chunk_table_offsets))
    return [(0, off) for off in jcfg.table_offsets]


def _from_jax(qemb, cfg, jcfg):
    return convert.quant_from_numpy([np.asarray(c) for c in qemb.chunks],
                                    [np.asarray(s) for s in qemb.scales],
                                    cfg, _placement(jcfg))


def _params(cfg, storage, seed=0, zero_rows=()):
    """JAX parameters in the given storage (some logical rows zeroed), and
    the port's numpy pytree of the same values."""
    jcfg = _jax(cfg, storage)
    jp = dlrm_tpu.init_params(jax.random.key(seed), jcfg)
    logical = np.array(jemb.unpack_tables(jp["emb"], jcfg))
    logical[list(zero_rows)] = 0
    jp = {**jp, "emb": jemb.pack_tables(jnp.asarray(logical), jcfg)}
    return jp, jcfg, jax_params_to_numpy(jp, jcfg)


CASES = [(name, dt) for name in ("packed16", "chunked128", "plain128")
         for dt in ("f32", "bf16")]


@pytest.mark.parametrize("name,dt", CASES)
def test_codes_and_scales_equal_jax_bit_for_bit(name, dt):
    kw = {"embedding_dtype": torch.bfloat16} if dt == "bf16" else {}
    cfg, storage = _cfg(name, **kw)
    zero = (0, 7, cfg.total_rows - 1)
    jp, jcfg, npp = _params(cfg, storage, zero_rows=zero)
    want = _from_jax(jquant.quantize_emb(jp["emb"], jcfg), cfg, jcfg)
    host = _from_jax(jquant.quantize_emb_host(
        tuple(np.asarray(c) for c in jp["emb"]) if jcfg.is_packed
        else np.asarray(jp["emb"]), jcfg), cfg, jcfg)
    assert torch.equal(want.codes, host.codes)
    assert torch.equal(want.scales, host.scales)
    emb = convert.params_from_numpy(npp, cfg)["emb"]
    assert emb.dtype == cfg.embedding_dtype
    logical = npp["emb"].astype(ml_dtypes.bfloat16) if dt == "bf16" \
        else npp["emb"]
    for got in (quant.quantize_emb(emb, cfg),
                quant.quantize_emb_host(logical, cfg)):
        assert got.codes.dtype == torch.int8
        assert got.scales.dtype == torch.float32
        assert torch.equal(got.codes, want.codes)
        assert torch.equal(got.scales, want.scales)
    # all-zero rows: zero codes, scale 1; the rest use the full range
    assert bool((want.codes[list(zero)] == 0).all())
    assert bool((want.scales[list(zero)] == 1).all())
    assert int(want.codes.abs().amax(dim=1)[1:5].min()) == 127


def test_quantizer_chunks_rows(monkeypatch):
    """Row chunks that do not divide the stack give the one-shot bits."""
    cfg, storage = _cfg("packed16")
    _, _, npp = _params(cfg, storage, seed=3)
    whole = quant.quantize_emb_host(npp["emb"], cfg)
    monkeypatch.setattr(quant, "CHUNK_ROWS", 333)
    emb = torch.from_numpy(npp["emb"].copy())
    for got in (quant.quantize_emb(emb, cfg),
                quant.quantize_emb_host(npp["emb"], cfg)):
        assert torch.equal(got.codes, whole.codes)
        assert torch.equal(got.scales, whole.scales)


def _ids(rng, cfg, b=32):
    shape = (b,) if cfg.n_hot == 1 else (b, cfg.n_hot)
    return np.stack([rng.integers(0, n, size=shape)
                     for n in cfg.table_sizes], axis=1).astype(np.int32)


@pytest.mark.parametrize("n_hot", [1, 3])
@pytest.mark.parametrize("name", ["packed16", "chunked128", "plain128"])
def test_lookup_and_forward_match_jax(name, n_hot, rng):
    """Small tables (one-hot matmul in JAX) and big ones (int8 gather)."""
    cfg, storage = _cfg(name, n_hot=n_hot)
    jp, jcfg, npp = _params(cfg, storage, seed=5)
    jq = jquant.quantize_params(jp, jcfg)
    qemb = _from_jax(jq["emb"], cfg, jcfg)
    ids = _ids(rng, cfg)
    dense = rng.normal(size=(32, 13)).astype(np.float32)
    want = np.asarray(jquant.quant_mixed_lookup(jq["emb"], jnp.asarray(ids),
                                                jcfg))
    got = quant.quant_mixed_lookup(qemb, torch.from_numpy(ids), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    params = {**convert.dense_from_numpy(npp, cfg), "emb": qemb}
    want = np.asarray(jax.jit(lambda p, d, s: dlrm_tpu.forward(p, d, s, jcfg))(
        jq, jnp.asarray(dense), jnp.asarray(ids)))
    got = dlrm_tpu_torch.forward(params, torch.from_numpy(dense),
                                 torch.from_numpy(ids), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the same through the port's own quantizer and embedding dispatch
    own = quant.quantize_params(convert.params_from_numpy(npp, cfg), cfg)
    np.testing.assert_array_equal(
        dlrm_tpu_torch.forward(own, torch.from_numpy(dense),
                               torch.from_numpy(ids), cfg).numpy(),
        got.numpy())


@pytest.mark.parametrize("n_hot", [1, 3])
def test_scores_within_5e3_of_f32(n_hot, rng):
    cfg, storage = _cfg("packed16", n_hot=n_hot)
    _, _, npp = _params(cfg, storage, seed=6)
    params = convert.params_from_numpy(npp, cfg)
    qparams = quant.quantize_params(params, cfg)
    dense = torch.from_numpy(rng.normal(size=(64, 13)).astype(np.float32))
    ids = torch.from_numpy(_ids(rng, cfg, 64))
    f32 = dlrm_tpu_torch.forward(params, dense, ids, cfg)
    q = dlrm_tpu_torch.forward(qparams, dense, ids, cfg)
    diff = float((f32 - q).abs().max())
    assert 0 < diff < 5e-3


def test_footprint_dequantize_and_guards():
    cfg, storage = _cfg("packed16")
    _, _, npp = _params(cfg, storage, seed=4)
    emb = torch.from_numpy(npp["emb"].copy())
    q = quant.quantize_emb(emb, cfg)
    assert quant.table_bytes(q) == cfg.total_rows * (cfg.feature_size + 4)
    assert "int8" in repr(q) and q.device == torch.device("cpu")
    deq = quant.dequantize_emb(q)
    step = emb.abs().amax(dim=1, keepdim=True) / 127
    assert bool(((deq - emb).abs() <= 0.5 * step + 1e-7).all())
    for t in range(cfg.num_tables):
        off, n = cfg.table_offsets[t], cfg.table_sizes[t]
        assert torch.equal(quant.quant_get_logical_table(q, cfg, t),
                           deq[off:off + n])
    bad = [
        quant.QuantEmb(q.codes[1:], q.scales[1:]),
        quant.QuantEmb(q.codes.to(torch.int16), q.scales),
        quant.QuantEmb(q.codes, q.scales[:, None]),
        quant.QuantEmb(q.codes, q.scales.double()),
    ]
    for b in bad:
        with pytest.raises(ValueError):
            quant.check_quant_storage(b, cfg)
        with pytest.raises(ValueError):
            dlrm_tpu_torch.forward({**convert.dense_from_numpy(npp, cfg),
                                    "emb": b}, torch.zeros(2, 13),
                                   torch.zeros(2, 8, dtype=torch.int32), cfg)
    with pytest.raises(ValueError, match="the config needs"):
        quant.quantize_emb(emb[1:], cfg)


def test_training_refuses_int8_tables(rng):
    cfg, storage = _cfg("packed16")
    _, _, npp = _params(cfg, storage, seed=4)
    params = quant.quantize_params(convert.params_from_numpy(npp, cfg), cfg)
    b = {"dense": torch.zeros(4, 13), "labels": torch.zeros(4),
         "sparse": torch.from_numpy(_ids(rng, cfg, 4))}
    k = {key: v[None] for key, v in b.items()}
    calls = [
        lambda: ttrain.train_step(params, b["dense"], b["sparse"],
                                  b["labels"], config=cfg, lr=0.1),
        lambda: ttrain.init_opt_state(params, config=cfg,
                                      optimizer="adagrad"),
        lambda: ttrain.train_step_opt(params, {"dense": None, "emb": None,
                                               "count": 0}, b["dense"],
                                      b["sparse"], b["labels"], config=cfg,
                                      optimizer="sgd", lr=0.1,
                                      grad_clip_norm=1.0),
        lambda: ttrain.train_block(params, k["dense"], k["sparse"],
                                   k["labels"], config=cfg, lr=0.1),
        lambda: dlrm_tpu_torch.train(params, [b], config=cfg, lr=0.1),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="cannot be trained"):
            call()


def _cli_json(capsys, fn, argv):
    assert fn(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def served_files(tmp_path, rng):
    """An HDF5 model written by the JAX package (26 tables of the CLI
    tests, fs 8), and a data file of 75 records."""
    cfg = dataclasses.replace(tc.tiny_config(), table_sizes=TABLES)
    jcfg = jax_config(cfg)
    jp = dlrm_tpu.init_params(jax.random.key(9), jcfg)
    h5, data = str(tmp_path / "m.h5"), str(tmp_path / "d.bin")
    jh5.save_params(h5, jp, jcfg)
    _write_dac(data, 75, rng)
    return h5, data, tmp_path


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_predict_and_eval_hdf5_match_the_jax_cli(quantize, served_files,
                                                 capsys):
    h5, data, tmp = served_files
    q = ["--quantize-tables", "int8"] if quantize else []
    scores = []
    for fn, out, extra in ((main, tmp / "o.npy", ["--device", "cpu"]),
                           (jrun.main, tmp / "t.npy", [])):
        line = _cli_json(capsys, fn, ["predict", "--hdf5", h5, "--data",
                                      data, "--batch-size", "32", "--out",
                                      str(out), *q, *extra])
        assert line["examples"] == 75
        scores.append(np.load(out))
    np.testing.assert_allclose(scores[0], scores[1], rtol=1e-6, atol=1e-6)
    got = _cli_json(capsys, main, ["eval", "--hdf5", h5, "--data", data,
                                   "--batch-size", "32", "--device", "cpu",
                                   *q])
    want = _cli_json(capsys, jrun.main, ["eval", "--hdf5", h5, "--data",
                                         data, "--batch-size", "32", *q])
    assert got["examples"] == want["examples"] == 75
    assert got["accuracy"] == want["accuracy"]
    for k in ("auc", "loss"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    if quantize:  # int8 serving moves the scores, within the bound
        f32 = _cli_json(capsys, main, ["predict", "--hdf5", h5, "--data",
                                       data, "--out", str(tmp / "f.npy"),
                                       "--device", "cpu"])
        assert f32["examples"] == 75
        diff = np.abs(np.load(tmp / "f.npy") - scores[0]).max()
        assert 0 < diff < 5e-3
