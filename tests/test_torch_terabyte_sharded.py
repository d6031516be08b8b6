"""The sharded path with host-resident row shards on the scaled Criteo
Terabyte model, on the CPU: ``train --sharded true --host-tables 0,19``.

The model is ``test_torch_terabyte.py``'s (fs=32, f32, its 26 tables cut
to 177,181 rows), the flags those the card runs at full size, where tables
0 and 19 (66.6 GB) become the one rank's host stack and the other 24
tables its slots on the card (``chip_smoke.py`` ``phase_terabyte``):

* against the JAX package's CLI with the same flags, both resuming from
  one planted step-0 state with warm row-wise accumulators (the JAX CLI's
  on its 8 devices, lane-packed; the port's one process, a gang of one):
  the tolerances of ``test_torch_sharded_cli.py`` (losses, tables and
  dense parameters 1e-5, accumulators 1e-6);
* against the port's own ``train --hbm-budget-gb`` on the same sizes, both
  drawing from the seed (the same bits, chunk by chunk): the loss lines and
  the final loss within 1e-5, the card's check, and each run's line naming
  its host tables.
"""

import contextlib
import io
import json

import numpy as np
import pytest

import test_torch_terabyte as tb
from dlrm_tpu_torch.run import main
from test_torch_sharded_cli import _jax_cli, _jax_state, _plant, _torch_state

CASE = dict(optimizer="rowwise_adagrad", max_rows_per_shard=None,
            col_sharded_tables=[], host_tables=[0, 19])
TRAIN = ["train", "--config", "terabyte", "--feature-size", "32",
         "--table-sizes", ",".join(map(str, tb.SCALED)), "--batch-size", "32",
         "--save-interval", "4"]
STEPS = 4


def _port_cli(argv) -> tuple:
    """``python -m dlrm_tpu_torch *argv --device cpu`` in process: (its
    JSON line, its stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main([*argv, "--device", "cpu"]) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs from the planted step 0 to step 4."""
    tmp = tmp_path_factory.mktemp("tb_sharded")
    jdir = tmp / "jax"
    jflags = ["--interaction", "gram"]
    plant = _plant(CASE, jdir, tmp, train=TRAIN, cfg=tb._cfg(), shards=1,
                   jflags=jflags)
    assert plant["p2"].host_row_sharded == (0, 19)
    assert plant["jp"].host_row_sharded == (0, 19)
    jline = _jax_cli([*plant["flags"], *jflags], str(STEPS), jdir)
    tline, err = _port_cli([*plant["flags"], "--interaction", "fused",
                            "--steps", str(STEPS), "--sharded", "true",
                            "--ckpt-dir", str(plant["tdir"])])
    return plant, jdir, jline, tline, err


@pytest.mark.parametrize("what", ["losses", "tables", "dense",
                                  "accumulators"])
def test_sharded_host_tables_cli_matches_the_jax_cli(runs, what):
    plant, jdir, jline, tline, err = runs
    if what == "losses":
        assert "host-resident row-sharded tables: [0, 19]" in err
        assert jline["steps"] == tline["steps"] == STEPS
        assert abs(jline["final_loss"] - tline["final_loss"]) <= 1e-5
        return
    want = _jax_state(jdir, plant["jp"], plant["jcfg"], CASE["optimizer"])
    got = _torch_state(plant["tdir"], plant["p2"], CASE["optimizer"],
                       plant["cfg"])
    if what == "tables":
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    elif what == "dense":
        for part in ("bottom", "top"):
            for a, b in zip(got[1][part], want[1][part]):
                for k in ("w", "b"):
                    np.testing.assert_allclose(a[k], b[k], atol=1e-5,
                                               rtol=0)
    else:
        assert got[4] == want[4] == STEPS
        np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=0)
        for part in ("bottom", "top"):
            for a, b in zip(got[3][part], want[3][part]):
                for k in ("w", "b"):
                    np.testing.assert_allclose(a[k], b[k], atol=1e-6,
                                               rtol=0)


# -- the sharded CLI against the two-tier CLI ---------------------------------

SEEDED = ["train", "--config", "terabyte", "--feature-size", "32",
          "--table-sizes", ",".join(map(str, tb.SCALED)), "--interaction",
          "fused", "--optimizer", "rowwise_adagrad", "--lr", "0.001",
          "--steps", "2", "--batch-size", "32", "--log-every", "1"]


def _loss_lines(err: str) -> list:
    return [float(line.split()[3]) for line in err.splitlines()
            if line.startswith("step ")]


def test_sharded_host_tables_cli_matches_the_two_tier_cli():
    """``--sharded true --host-tables 0,19`` against ``--hbm-budget-gb``
    (tables 0 and 19 in the host tier), 2 row-wise steps from the seed's
    draw: loss lines and final loss within 1e-5."""
    tier, tier_err = _port_cli([*SEEDED, "--hbm-budget-gb",
                                str(tb.BUDGET_GB)])
    sh, sh_err = _port_cli([*SEEDED, "--sharded", "true", "--host-tables",
                            "0,19"])
    assert "host-tier tables: [0, 19] (52,037 rows)" in tier_err
    assert ("host-resident row-sharded tables: [0, 19] (52,038 rows a "
            "shard in host memory)") in sh_err
    assert "sharded over 1 process(es)" in sh_err
    lines = [_loss_lines(e) for e in (tier_err, sh_err)]
    assert len(lines[0]) == len(lines[1]) == 2
    np.testing.assert_allclose(lines[1], lines[0], atol=1e-5, rtol=0)
    assert tier["steps"] == sh["steps"] == 2
    assert abs(tier["final_loss"] - sh["final_loss"]) <= 1e-5
