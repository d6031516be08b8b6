"""dlrm_tpu_torch's serving surface against dlrm_tpu's: the Criteo loader,
``python -m dlrm_tpu_torch predict`` against ``jax.jit(forward)``, the
parameter converter, and the rule that the port imports no JAX."""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import dlrm_tpu
import dlrm_tpu_torch
from dlrm_tpu.data.criteo import DACLoader as JaxDACLoader
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.data import criteo as tcriteo
from dlrm_tpu_torch.data.synthetic import batch_stream
from dlrm_tpu_torch.io import convert
from dlrm_tpu_torch.run import _build_config, build_parser, main
from test_torch_model import jax_config, jax_params_to_numpy

REPO = Path(__file__).resolve().parent.parent
TABLES = (5, 300, 17, 2000, 3, 60) * 4 + (9, 700)  # 26 tables


def _write_dac(path, n, rng, table_sizes=TABLES):
    rec = np.zeros(n, dtype=tcriteo.DAC_DTYPE)
    rec["label"] = rng.integers(0, 2, size=n)
    rec["dense"] = np.log1p(rng.integers(0, 1000, size=(n, 13))
                            ).astype(np.float32)
    rec["cat"] = np.stack([rng.integers(1, s + 1, size=n)
                           for s in table_sizes], axis=1)
    rec.tofile(path)


def test_dac_dtype_matches():
    from dlrm_tpu.data import criteo as jcriteo
    assert tcriteo.DAC_DTYPE == jcriteo.DAC_DTYPE
    assert tcriteo.DAC_DTYPE.itemsize == 160
    assert (tcriteo.NUM_DENSE, tcriteo.NUM_SPARSE) == (13, 26)


@pytest.mark.parametrize("drop_remainder", [False, True])
def test_dac_loader_matches_jax(drop_remainder, tmp_path, rng):
    path = str(tmp_path / "d.bin")
    _write_dac(path, 203, rng)
    data = tcriteo.load(path)
    ours = tcriteo.DACLoader(data, 64, drop_remainder=drop_remainder)
    theirs = JaxDACLoader(data, 64, drop_remainder=drop_remainder,
                          use_native=False)
    assert len(ours) == len(theirs) == (3 if drop_remainder else 4)
    got, want = list(ours), list(theirs)
    assert [b["dense"].shape[0] for b in got] == \
        ([64] * 3 if drop_remainder else [64, 64, 64, 11])
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert got[-1]["sparse"].min() >= 0  # 1-based file ids shifted
    for k in got[-1]:
        np.testing.assert_array_equal(ours[-1][k], theirs[-1][k])
    with pytest.raises(IndexError):
        ours[len(ours)]


def test_batch_stream_matches_jax():
    from dlrm_tpu.data.synthetic import batch_stream as jstream
    cfg = tc.tiny_config(num_tables=5, rows=77, n_hot=2)
    for g, w in zip(batch_stream(cfg, 8, 3, seed=4),
                    jstream(jax_config(cfg), 8, 3, seed=4)):
        for k in ("dense", "sparse", "labels"):
            np.testing.assert_array_equal(g[k], w[k])


def _tiny26(**kw):
    return dataclasses.replace(tc.tiny_config(), table_sizes=TABLES, **kw)


def _init(cfg):
    return dlrm_tpu_torch.init_params(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("interaction", ["gram", "fused"])
def test_predict_matches_jax_forward(interaction, tmp_path, rng):
    """`predict` on a binarized file scores every row, ragged tail
    included, in input order: the scores of jax.jit(forward) to 1e-6."""
    tcfg = _tiny26(interaction_impl=interaction)
    jcfg = jax_config(tcfg)
    jparams = dlrm_tpu.init_params(jax.random.key(5), jcfg)
    data, params, out = (str(tmp_path / n)
                         for n in ("d.bin", "p.npz", "s.npy"))
    _write_dac(data, 150, rng)
    convert.save_npz(params, jax_params_to_numpy(jparams, jcfg))
    argv = ["predict", "--config", "tiny", "--table-sizes",
            ",".join(map(str, TABLES)), "--data", data, "--params", params,
            "--out", out, "--batch-size", "64", "--interaction", interaction,
            "--device", "cpu"]
    assert main(argv) == 0
    got = np.load(out)
    assert got.shape == (150,) and got.dtype == np.float32
    loader = JaxDACLoader(np.fromfile(data, dtype=tcriteo.DAC_DTYPE), 150,
                          use_native=False)
    batch = loader[0]
    fwd = jax.jit(lambda p, d, s: dlrm_tpu.forward(p, d, s, jcfg))
    want = np.asarray(fwd(jparams, jnp.asarray(batch["dense"]),
                          jnp.asarray(batch["sparse"])))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_predict_prints_json_line(tmp_path, rng, capsys):
    tcfg = _tiny26()
    params = _init(tcfg)
    data, pz, out = (str(tmp_path / n) for n in ("d.bin", "p.npz", "s.npy"))
    _write_dac(data, 70, rng)
    convert.save_npz(pz, convert.params_to_numpy(params))
    main(["predict", "--config", "tiny", "--table-sizes",
          ",".join(map(str, TABLES)), "--data", data, "--params", pz,
          "--out", out, "--batch-size", "32", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["examples"] == 70 and line["out"] == out
    assert set(line) == {"examples", "out", "seconds", "mean_score",
                         "device"}
    assert line["mean_score"] == pytest.approx(float(np.load(out).mean()))


@pytest.mark.parametrize("device", ["cpu", None])
def test_predict_line_reports_the_device(device, tmp_path, rng, capsys):
    """The line names the device the scores were computed on.  Without
    --device the command runs on the GPU; with no GPU it exits naming
    --device cpu instead of falling back to the CPU."""
    tcfg = _tiny26()
    data, pz, out = (str(tmp_path / n) for n in ("d.bin", "p.npz", "s.npy"))
    _write_dac(data, 40, rng)
    convert.save_npz(pz, convert.params_to_numpy(_init(tcfg)))
    argv = ["predict", "--config", "tiny", "--table-sizes",
            ",".join(map(str, TABLES)), "--data", data, "--params", pz,
            "--out", out]
    if device:
        argv += ["--device", device]
    elif not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            main(argv)
        assert not Path(out).exists()
        return
    main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == (device or "cuda")


@pytest.mark.parametrize("flag,value", [("--exchange-dtype", "bf16")])
def test_predict_exchange_dtype_serves_on_the_mesh(flag, value, tmp_path,
                                                   rng, capsys):
    """A sharded run's checkpoint scored on a mesh of this process: the
    bf16 exchange rounds each pooled row once, so its scores stay within
    1e-2 of the f32 exchange's, which equal the unsharded scores."""
    data, ckd = str(tmp_path / "d.bin"), str(tmp_path / "ck")
    _write_dac(data, 70, rng)
    model = ["--config", "tiny", "--table-sizes",
             ",".join(map(str, TABLES)), "--device", "cpu", "--batch-size",
             "32"]
    assert main(["train", *model, "--steps", "2", "--sharded", "true",
                 "--max-rows-per-shard", "1000", "--ckpt-dir", ckd]) == 0
    outs = {}
    for name, extra in (("one", []), ("mesh", ["--sharded", "true"]),
                        ("wire", ["--sharded", "true", flag, value])):
        outs[name] = str(tmp_path / f"{name}.npy")
        assert main(["predict", *model, "--ckpt-dir", ckd, "--data", data,
                     "--out", outs[name], *extra]) == 0
    one, mesh, wire = (np.load(outs[k]) for k in ("one", "mesh", "wire"))
    assert one.shape == (70,)
    np.testing.assert_allclose(mesh, one, atol=1e-6, rtol=0)
    assert np.abs(wire - mesh).max() <= 1e-2


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_predict_ckpt_dir_scores_the_trained_parameters(optimizer, tmp_path,
                                                        rng, capsys):
    """``predict --ckpt-dir``: the scores of score_batch on the newest
    checkpoint's parameters (an optimizer run's ``{"params", "opt"}``
    unwrapped), every row in order."""
    from dlrm_tpu_torch.io import checkpoint as ck
    from dlrm_tpu_torch.run import score_batch

    tcfg = _tiny26()
    data, d, out = (str(tmp_path / n) for n in ("d.bin", "ck", "s.npy"))
    _write_dac(data, 70, rng)
    model = ["--config", "tiny", "--table-sizes", ",".join(map(str, TABLES)),
             "--device", "cpu"]
    main(["train", *model, "--steps", "3", "--batch-size", "32",
          "--optimizer", optimizer, "--ckpt-dir", d])
    main(["predict", *model, "--data", data, "--out", out, "--batch-size",
          "32", "--ckpt-dir", d])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["examples"] == 70 and line["device"] == "cpu"
    payload, step = ck.restore_checkpoint(d)
    assert step == 3
    params = payload if optimizer == "sgd" else payload["params"]
    batch = tcriteo.DACLoader(tcriteo.load(data), 70)[0]
    np.testing.assert_array_equal(
        np.load(out), score_batch(params, batch, tcfg, torch.device("cpu")))


@pytest.mark.parametrize("flag", ["--hdf5", "--quantize-tables",
                                  "--validate-data"])
def test_predict_flags_now_served(flag, tmp_path, rng, capsys):
    """--hdf5 (a model written by io/hdf5.save_params; the file's config),
    --quantize-tables int8 (quantized on the host from --params) and
    --validate-data: the scores of score_batch on the same parameters."""
    from dlrm_tpu_torch.io import hdf5
    from dlrm_tpu_torch.ops.quant import quantize_params
    from dlrm_tpu_torch.run import score_batch

    tcfg = _tiny26()
    params = _init(tcfg)
    data, pz, out, h5 = (str(tmp_path / n)
                         for n in ("d.bin", "p.npz", "s.npy", "m.h5"))
    _write_dac(data, 70, rng)
    convert.save_npz(pz, convert.params_to_numpy(params))
    hdf5.save_params(h5, convert.params_to_numpy(params), tcfg)
    model = ["--params", pz, "--config", "tiny", "--table-sizes",
             ",".join(map(str, TABLES))]
    extra = {"--hdf5": ["--hdf5", h5],
             "--quantize-tables": model + ["--quantize-tables", "int8"],
             "--validate-data": model + ["--validate-data"]}[flag]
    main(["predict", "--data", data, "--out", out, "--batch-size", "32",
          "--device", "cpu", *extra])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["examples"] == 70
    if flag == "--quantize-tables":
        params = quantize_params(params, tcfg)
    batch = tcriteo.DACLoader(tcriteo.load(data), 70)[0]
    np.testing.assert_array_equal(np.load(out),
                                  score_batch(params, batch, tcfg,
                                              torch.device("cpu")))


def test_predict_rejects_pallas_name():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["predict", "--out", "o",
                                   "--interaction", "pallas"])


@pytest.mark.parametrize("device,fs,flag,want", [
    ("cuda", 128, None, "fused"),
    ("cuda", 16, None, "gram"),
    ("cpu", 128, None, "gram"),
    ("cuda", 128, "gram", "gram"),
    ("cpu", 16, "fused", "fused"),
])
def test_interaction_auto_rule(device, fs, flag, want):
    """On CUDA, with --interaction not given, fs=128 takes the fused
    kernel (the JAX package's accelerator-only rule)."""
    argv = ["predict", "--out", "o", "--feature-size", str(fs)]
    if flag:
        argv += ["--interaction", flag]
    args = build_parser().parse_args(argv)
    cfg = _build_config(args, torch.device(device))
    assert cfg.interaction_impl == want
    assert cfg.feature_size == fs and cfg.table_sizes == tc.KAGGLE_TABLE_SIZES


def test_build_config_flags():
    args = build_parser().parse_args(
        ["predict", "--out", "o", "--config", "terabyte", "--feature-size",
         "64", "--n-hot", "3", "--bf16", "--bf16-tables", "--pad-to", "8"])
    cfg = _build_config(args, torch.device("cpu"))
    assert (cfg.feature_size, cfg.n_hot, cfg.interaction_pad_to) == (64, 3, 8)
    assert cfg.compute_dtype == cfg.embedding_dtype == torch.bfloat16
    assert cfg.top_input % 8 == 0


def test_convert_round_trip(tmp_path):
    cfg = dataclasses.replace(tc.tiny_config(),
                              embedding_dtype=torch.bfloat16)
    params = _init(cfg)
    path = str(tmp_path / "p.npz")
    convert.save_npz(path, convert.params_to_numpy(params))
    back = convert.params_from_numpy(convert.load_npz(path), cfg)
    assert back["emb"].dtype == torch.bfloat16
    torch.testing.assert_close(back["emb"], params["emb"], rtol=0, atol=0)
    for part in ("bottom", "top"):
        for a, b in zip(back[part], params[part]):
            for k in ("w", "b"):
                torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_convert_takes_ml_dtypes_bf16_and_checks_shapes():
    cfg = tc.tiny_config()
    np_params = convert.params_to_numpy(_init(cfg))
    np_params["emb"] = np_params["emb"].astype(ml_dtypes.bfloat16)
    p = convert.params_from_numpy(np_params, cfg)
    np.testing.assert_array_equal(p["emb"].numpy(),
                                  np_params["emb"].astype(np.float32))
    np_params["emb"] = np_params["emb"][:, :4]
    with pytest.raises(ValueError, match="emb"):
        convert.params_from_numpy(np_params, cfg)
    np_params = convert.params_to_numpy(_init(cfg))
    np_params["top"] = np_params["top"][:1]
    with pytest.raises(ValueError, match="top"):
        convert.params_from_numpy(np_params, cfg)


def test_import_pulls_in_no_jax():
    code = ("import sys, pkgutil, importlib, dlrm_tpu_torch\n"
            "for m in pkgutil.walk_packages(dlrm_tpu_torch.__path__, "
            "'dlrm_tpu_torch.'):\n"
            "    if not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'h5py')) or m == 'dlrm_tpu' "
            "or m.startswith('dlrm_tpu.')]\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_package_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|dlrm_tpu)(\.|\s|$)",
                     re.M)
    pkg = REPO / "dlrm_tpu_torch"
    files = [f for f in pkg.rglob("*.py")
             if "_build" not in f.relative_to(pkg).parts]  # build outputs
    assert len(files) > 10
    for f in files + [REPO / "chip_smoke.py"]:
        assert not pat.search(f.read_text()), f

