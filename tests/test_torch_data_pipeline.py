"""dlrm_tpu_torch's Criteo pipeline against dlrm_tpu's on the same text:
parsing, ``binarize`` (plain and .gz), ``process``, the vocabulary and its
.npz, ``reindex`` and ``validate_ids`` give the same arrays, the same
messages and byte-identical files, with and without the port's native
library; the native parser, marshal and vocabulary against the port's numpy
path; ``DACLoader`` with ``local_rows`` and the shuffles;
``criteo_text_lines`` and ``rows=``; ``python -m dlrm_tpu_torch
preprocess`` against the JAX CLI; and where the native library is built."""

import gzip
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dlrm_tpu import run as jrun
from dlrm_tpu.data import criteo as jcriteo
from dlrm_tpu.data import synthetic as jsyn
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.data import criteo, native, synthetic
from test_torch_model import jax_config

REPO = Path(__file__).resolve().parent.parent
USE_NATIVE = [pytest.param(False, id="numpy"), pytest.param(True, id="native")]


def _text(tmp_path, name, n, seed, gz=False, vocab=1000):
    lines = synthetic.criteo_text_lines(n, seed=seed, vocab=vocab)
    path = tmp_path / (name + (".txt.gz" if gz else ".txt"))
    with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
        f.writelines(lines)
    return str(path), lines


def _bytes(path) -> bytes:
    return Path(path).read_bytes()


def _want_native(use_native):
    if use_native:
        assert native.available(), "the native library should build here"


def test_criteo_text_lines_and_parse_lines_match_jax():
    lines = synthetic.criteo_text_lines(300, seed=4, missing_prob=0.2,
                                        vocab=50)
    assert lines == jsyn.criteo_text_lines(300, seed=4, missing_prob=0.2,
                                           vocab=50)
    got = criteo.parse_lines(lines + ["\n"])  # a blank line is skipped
    want = jcriteo.parse_lines(lines)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="tab-separated fields, got 3"):
        criteo.parse_lines(["1\t2\t3\n"])


@pytest.mark.parametrize("gz", [False, True], ids=["txt", "gz"])
@pytest.mark.parametrize("use_native", USE_NATIVE)
def test_binarize_writes_the_jax_bytes(gz, use_native, tmp_path):
    _want_native(use_native)
    src, _ = _text(tmp_path, "day", 500, seed=1, gz=gz)
    ours, theirs = str(tmp_path / "ours.bin"), str(tmp_path / "theirs.bin")
    got = criteo.binarize(src, ours, use_native=use_native, chunk_lines=128)
    want = jcriteo.binarize(src, theirs, use_native=False)
    assert len(got) == 500 and _bytes(ours) == _bytes(theirs)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_native_stream_cuts_at_line_ends(tmp_path):
    """Chunks smaller than a line: the parse stream carries the partial
    line over and gives the numpy records."""
    src, lines = _text(tmp_path, "day", 40, seed=2)
    with open(src, "rb") as f:
        chunks = criteo._native_parse_stream(f, chunk_bytes=100)
    got = np.concatenate(chunks)
    assert len(chunks) > 1
    assert got.tobytes() == criteo.parse_lines(lines).tobytes()


@pytest.mark.parametrize("use_native", USE_NATIVE)
def test_process_writes_the_jax_binary_and_vocab(use_native, tmp_path):
    _want_native(use_native)
    a, _ = _text(tmp_path, "a", 300, seed=3)
    b, _ = _text(tmp_path, "b", 200, seed=5, gz=True)
    out = {}
    for name, mod, kw in (("ours", criteo, {"use_native": use_native}),
                          ("theirs", jcriteo, {"use_native": False})):
        binp = str(tmp_path / f"{name}.bin")
        vocp = str(tmp_path / f"{name}_vocab.npz")
        data = mod.process([a, b], binpath=binp, vocab_path=vocp, **kw)
        out[name] = (np.asarray(data).copy(), _bytes(binp), _bytes(vocp))
    assert out["ours"][1] == out["theirs"][1]
    assert out["ours"][2] == out["theirs"][2]
    cat = out["ours"][0]["cat"]
    assert cat.min() == 1  # dense 1-based ids in the file


def test_vocabulary_reindex_and_npz_match_jax(tmp_path):
    shards = [criteo.parse_lines(synthetic.criteo_text_lines(n, seed=s,
                                                             vocab=60))
              for n, s in ((150, 7), (90, 8))]
    ours = criteo.build_vocabulary(shards)
    theirs = jcriteo.build_vocabulary(shards)
    assert ours.sizes == theirs.sizes and max(ours.sizes) <= 61
    for j in range(criteo.NUM_SPARSE):
        np.testing.assert_array_equal(ours.sorted_values[j],
                                      theirs.sorted_values[j])
        np.testing.assert_array_equal(ours.ranks[j], theirs.ranks[j])
    ours.save(str(tmp_path / "o.npz"))
    theirs.save(str(tmp_path / "t.npz"))
    assert _bytes(tmp_path / "o.npz") == _bytes(tmp_path / "t.npz")
    back = criteo.Vocabulary.load(str(tmp_path / "o.npz"))
    assert back.sizes == ours.sizes
    # the native export order (first appearance) rebuilds the same maps
    joined = np.concatenate(shards)
    appear = [_first_appearance(joined["cat"][:, j]) for j in range(26)]
    again = criteo.Vocabulary.from_appearance(appear)
    for j in range(criteo.NUM_SPARSE):
        np.testing.assert_array_equal(again.ranks[j], ours.ranks[j])
    got, want = joined.copy(), joined.copy()
    criteo.reindex(got, ours)
    jcriteo.reindex(want, theirs)
    assert got.tobytes() == want.tobytes()
    with pytest.raises(KeyError, match="column 0: value not in vocabulary"):
        ours.remap_column(0, np.asarray([10 ** 6], np.uint32))


def _first_appearance(col):
    uniq, first = np.unique(col, return_index=True)
    return uniq[np.argsort(first, kind="stable")]


def test_validate_ids_message_matches_jax(tmp_path):
    src, _ = _text(tmp_path, "day", 400, seed=9, vocab=1000)
    data = criteo.process(src, use_native=False)
    sizes = list(tc.KAGGLE_TABLE_SIZES)
    msgs = []
    for mod in (criteo, jcriteo):
        with pytest.raises(ValueError) as e:
            mod.validate_ids(data, sizes, chunk=64)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert re.match(r"record \d+, column \d+: id \d+ outside \[1, \d+\) ",
                    msgs[0]), msgs[0]
    criteo.validate_ids(data, [10 ** 6] * 26)  # in range: passes
    with pytest.raises(ValueError, match="expected 26 table sizes"):
        criteo.validate_ids(data, [10] * 3)


def test_native_parser_marshal_and_vocab_match_numpy(tmp_path):
    assert native.available()
    lines = synthetic.criteo_text_lines(700, seed=11, vocab=300)
    text = "".join(lines).encode()
    recs = native.parse_buffer(text, num_threads=3)
    want = criteo.parse_lines(lines)
    assert recs.tobytes() == want.tobytes()
    for start, count, shift in ((0, 64, 1), (100, 333, 1), (650, 50, 0)):
        got = native.marshal_batch(recs, start, count, shift)
        w = recs[start:start + count]
        np.testing.assert_array_equal(got["labels"], w["label"])
        np.testing.assert_array_equal(got["dense"], w["dense"])
        np.testing.assert_array_equal(
            got["sparse"], w["cat"].astype(np.int64) - shift)
    reidx = recs.copy()
    appear = native.build_vocab_and_reindex(reidx, num_threads=2)
    vocab = criteo.build_vocabulary([want])
    for j in range(26):
        np.testing.assert_array_equal(appear[j], _first_appearance(want["cat"][:, j]))
    numpy_side = want.copy()
    criteo.reindex(numpy_side, vocab)
    assert reidx.tobytes() == numpy_side.tobytes()


@pytest.mark.parametrize("bad,match", [
    (lambda r: native.marshal_batch(r, 690, 20), "outside records"),
    (lambda r: native.marshal_batch(r[::2], 0, 4), "C-contiguous"),
    (lambda r: native.build_vocab_and_reindex(r.view(np.uint8)),
     "DAC_DTYPE"),
    (lambda r: native.build_vocab_and_reindex(
        np.frombuffer(r.tobytes(), criteo.DAC_DTYPE)), "writable"),
    (lambda r: native.parse_buffer(b"1\t2\n"), "malformed Criteo line 1"),
])
def test_native_refuses_bad_input(bad, match):
    recs = criteo.parse_lines(synthetic.criteo_text_lines(700, seed=1))
    with pytest.raises(ValueError, match=match):
        bad(recs)


@pytest.mark.parametrize("kw", [
    {"local_rows": (16, 48)},
    {"local_rows": (0, 32), "shuffle": True, "seed": 2},
    {"local_rows": (40, 64), "shuffle_rows": True, "shuffle_window": 3},
    {"drop_remainder": False, "shuffle": True},
    {"shuffle_rows": True, "seed": 7},
])
@pytest.mark.parametrize("use_native", USE_NATIVE)
def test_dac_loader_matches_jax(kw, use_native, tmp_path):
    _want_native(use_native)
    src, _ = _text(tmp_path, "day", 517, seed=12)
    data = criteo.process(src, binpath=str(tmp_path / "d.bin"),
                          use_native=False)
    ours = criteo.DACLoader(data, 64, use_native=use_native, **kw)
    theirs = jcriteo.DACLoader(data, 64, use_native=False, **kw)
    assert len(ours) == len(theirs)
    for _ in range(2):  # two epochs: each draws its own order
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    for i in (0, -1):
        for k, v in ours[i].items():
            np.testing.assert_array_equal(v, theirs[i][k])


def test_dac_loader_local_rows_checks():
    data = np.zeros(100, criteo.DAC_DTYPE)
    with pytest.raises(ValueError, match="outside batch size"):
        criteo.DACLoader(data, 32, local_rows=(10, 40))
    with pytest.raises(ValueError, match="needs drop_remainder=True"):
        criteo.DACLoader(data, 32, local_rows=(0, 16), drop_remainder=False)


@pytest.mark.parametrize("n_hot", [1, 2])
def test_rows_slices_match_jax(n_hot):
    cfg = tc.tiny_config(num_tables=5, rows=300, n_hot=n_hot)
    jcfg = jax_config(cfg)
    full = list(synthetic.batch_stream(cfg, 64, 3, seed=5))
    for lo, hi in ((0, 16), (16, 64)):
        got = list(synthetic.batch_stream(cfg, 64, 3, seed=5, rows=(lo, hi)))
        want = list(jsyn.batch_stream(jcfg, 64, 3, seed=5, rows=(lo, hi)))
        truth = synthetic.ClickthroughModel(cfg, seed=12345)
        jtruth = jsyn.ClickthroughModel(jcfg, seed=12345)
        got += list(truth.stream(64, 2, seed=1, rows=(lo, hi)))
        want += list(jtruth.stream(64, 2, seed=1, rows=(lo, hi)))
        for g, w in zip(got, want):
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
        for g, f in zip(got[:3], full):
            np.testing.assert_array_equal(g["sparse"], f["sparse"][lo:hi])


def _tree_hash(path: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.iterdir()) if p.is_file()}


def test_native_build_lands_in_build_dir_and_leaves_native_alone(
        tmp_path, monkeypatch):
    native_dir = REPO / "native"
    before = _tree_hash(native_dir)
    # a fresh build directory: the library is built from the source there
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_state", {})
    assert native.available()
    lib = native.lib_path()
    assert lib.parent == tmp_path / "_build" and lib.exists()
    assert not list((tmp_path / "_build").glob("*.tmp"))
    assert native.lib_path().name == lib.name  # same source: same name
    assert _tree_hash(native_dir) == before
    # the package's own build directory is the gitignored one
    assert "dlrm_tpu_torch/_build/" in (REPO / ".gitignore").read_text()
    git = subprocess.run(["git", "status", "--porcelain", "native"],
                         cwd=REPO, capture_output=True, text=True)
    if git.returncode == 0:  # a git checkout: nothing under native/ changed
        assert git.stdout == ""


def test_failed_native_build_says_why_and_falls_back(tmp_path, monkeypatch,
                                                     capsys):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_state", {})
    assert not native.available()
    assert not native.available()  # tried once
    err = capsys.readouterr().err
    assert err.count("native data engine build failed") == 1
    assert "bad.cpp" in err
    lines = synthetic.criteo_text_lines(50, seed=1)
    src = tmp_path / "t.txt"
    src.write_text("".join(lines))
    got = criteo.binarize(str(src))  # the numpy path
    assert got.tobytes() == criteo.parse_lines(lines).tobytes()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.parse_buffer(b"")


def test_preprocess_cli_matches_jax(tmp_path, capsys):
    a, _ = _text(tmp_path, "a", 250, seed=13)
    b, _ = _text(tmp_path, "b", 120, seed=14, gz=True)
    ours = [str(tmp_path / f) for f in ("o.bin", "o_vocab.npz")]
    theirs = [str(tmp_path / f) for f in ("t.bin", "t_vocab.npz")]
    res = subprocess.run(
        [sys.executable, "-m", "dlrm_tpu_torch", "preprocess", a, b,
         "--out", ours[0], "--vocab", ours[1]],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert jrun.main(["preprocess", a, b, "--out", theirs[0], "--vocab",
                      theirs[1]]) == 0
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["native"] is True
    assert {k: line[k] for k in ("records", "vocab_sizes")} == \
        {k: jline[k] for k in ("records", "vocab_sizes")}
    assert line["records"] == 370 and line["out"] == ours[0]
    for o, t in zip(ours, theirs):
        assert _bytes(o) == _bytes(t)
