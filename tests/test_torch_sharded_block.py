"""dlrm_tpu_torch's sharded K-step blocks (``train.sharded_train_block``,
``sharded_train_block_opt`` and their makers) against the sharded step and
against dlrm_tpu's ``make_sharded_train_block`` /
``make_sharded_train_block_opt`` on the CPU.

A sharded block reads EVERY table as of block entry (the single-device
block freezes only its big tables), so it is held to the JAX package's
sharded block, not to ``train_block``.  A process group of one rank holds
a K=1 block to the sharded step bit for bit (SGD, Adagrad and row-wise
Adagrad).  Gloo gangs of 2 ranks (``torch_gang_worker.py``) run two K=2
blocks against the JAX package's on ``make_mesh(2)``, on the placement of
``test_torch_sharded_optim.py`` (slot, device row-sharded, host row-sharded
and column-sharded tables) from one state: SGD under a clip that binds,
SGD under a schedule (each micro-step's gradient scaled by its own lr),
Adagrad multi-hot under a schedule (the twin payload ``(g, lr_k * g)``,
routed at double width, the column shards' halves in separate exchanges)
and row-wise Adagrad one-hot with a clip.  Tolerances as that file's: 1e-5
on losses, tables and dense parameters, 1e-6 on the accumulators (warm),
trash rows exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.parallel.mesh import block_batch_sharding, make_mesh
from dlrm_tpu.parallel.placement import plan_placement as jax_plan
from dlrm_tpu.train import train as jtrain
from dlrm_tpu_torch.data.synthetic import random_batch
from dlrm_tpu_torch.io import convert
from dlrm_tpu_torch.models import dlrm as tmodel
from dlrm_tpu_torch.parallel.placement import plan_placement
from dlrm_tpu_torch.train import train as ttrain
from test_torch_sharded_lookup import SIZES, jax_start, spec_config, tiny
from test_torch_sharded_optim import (CHECKS, KEYS, KINDS_H, WARMUP,
                                      compare, gang_result,
                                      jax_device_params, jax_lr,
                                      jax_opt_state, jax_result,
                                      jax_sharded_h, logical, sharded_copy,
                                      solo, warm_state)  # noqa: F401
from torch_gang_worker import jax_opt_arrays, jax_sharded_arrays, run_gang

K = 2
BLOCKS = 2


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rowwise_adagrad"])
def test_k1_block_is_the_step(solo, optimizer, rng):
    """At K=1 a block is the sharded step: the same losses and the same
    bits in every table, dense parameter and accumulator."""
    config = tiny(2)
    p = plan_placement(SIZES, 1, **KINDS_H)
    params = tmodel.init_params(torch.Generator().manual_seed(8), config)
    runs = []
    for blocked in (False, True):
        sh = sharded_copy(params, p, config)
        st = ttrain.init_sharded_opt_state(sh, config=config,
                                           optimizer=optimizer)
        gen = np.random.default_rng(9)
        losses = []
        for _ in range(2):
            b = [torch.as_tensor(v) for v in
                 (random_batch(gen, config, 16)[k] for k in KEYS)]
            if not blocked:
                losses.append(ttrain.sharded_train_step_opt(
                    sh, st, *b, config=config, optimizer=optimizer, lr=0.3,
                    mesh=solo, placement=p, grad_clip_norm=0.05))
            elif optimizer == "sgd":
                losses.append(ttrain.sharded_train_block(
                    sh, *(t[None] for t in b), config=config, lr=0.3,
                    mesh=solo, placement=p, grad_clip_norm=0.05)[0])
            else:
                losses.append(ttrain.sharded_train_block_opt(
                    sh, st, *(t[None] for t in b), config=config, lr=0.3,
                    mesh=solo, placement=p, optimizer=optimizer,
                    grad_clip_norm=0.05)[0])
        runs.append((torch.stack(losses), logical(
            convert.sharded_params_to_numpy([sh]), p, config),
            convert.sharded_opt_state_to_numpy([st]), sh))
    (l0, t0, o0, s0), (l1, t1, o1, s1) = runs
    assert torch.equal(l0, l1)
    np.testing.assert_array_equal(t0, t1)
    for part in ("bottom", "top"):
        for a, b in zip(s0[part], s1[part]):
            assert all(torch.equal(a[k], b[k]) for k in ("w", "b"))
    if optimizer != "sgd":
        assert o0["count"] == o1["count"] == 2
        for key in ("emb_acc", "emb_acc_h"):
            np.testing.assert_array_equal(o0[key], o1[key])
        for a, b in zip(o0["emb_acc_cs"], o1["emb_acc_cs"]):
            np.testing.assert_array_equal(a, b)


def test_block_opt_refuses_sgd(solo):
    config = tiny()
    p = plan_placement(SIZES, 1, **KINDS_H)
    with pytest.raises(ValueError, match="sharded_train_block"):
        ttrain.sharded_train_block_opt({}, {"count": 0}, torch.zeros(1, 2, 13),
                                       None, None, config=config, lr=0.1,
                                       mesh=solo, placement=p,
                                       optimizer="sgd")


GANGS = {  # task, optimizer, n_hot, lr, clip
    "sgd": ("block", "sgd", 1, 0.5, 0.05),
    "sgd_scheduled": ("block", "sgd", 2, {"base": 0.5, "schedule": WARMUP},
                      None),
    "adagrad_scheduled": ("block_opt", "adagrad", 2,
                          {"base": 0.1, "schedule": WARMUP}, None),
    "rowwise": ("block_opt", "rowwise_adagrad", 1, 0.2, 0.05),
}


def stacked_batches(rng, tcfg, b: int = 16) -> list:
    """BLOCKS global blocks (K, b, ...), ids repeated within and across
    the micro-batches of the first."""
    out = []
    for i in range(BLOCKS):
        micro = [random_batch(rng, tcfg, b) for _ in range(K)]
        if i == 0:
            micro[0]["sparse"][1] = micro[0]["sparse"][0]
            micro[1]["sparse"][2] = micro[0]["sparse"][0]
        out.append({k: np.stack([m[k] for m in micro]) for k in KEYS})
    return out


@pytest.fixture(scope="module", params=sorted(GANGS))
def gang(request, tmp_path_factory):
    """BLOCKS K=2 blocks of one gang and of the JAX package's sharded block
    from one state."""
    task, optimizer, n_hot, lr, clip = GANGS[request.param]
    rng = np.random.default_rng(17)
    tcfg = tiny(n_hot)
    jcfg, _, np_params = jax_start(tcfg, seed=6)
    jp = jax_plan(SIZES, 2, pack=1, **KINDS_H)
    sh = jax_sharded_h(np_params, jcfg, jp)
    np_opt = warm_state(rng, sh, jp, optimizer)
    blocks = stacked_batches(rng, tcfg)
    arrays = {**jax_sharded_arrays(sh), **jax_opt_arrays(np_opt),
              **{f"{k}.{s}": b[k] for s, b in enumerate(blocks)
                 for k in KEYS}}
    ranks = run_gang(tmp_path_factory.mktemp(f"block{request.param}"), 2,
                     {"config": spec_config(tcfg), "placement": KINDS_H,
                      "mesh": None, "task": task, "optimizer": optimizer,
                      "lr": lr, "clip": clip, "blocks": BLOCKS}, arrays)

    mesh = make_mesh(2)
    params = jax_device_params(sh, mesh)
    bs = block_batch_sharding(mesh)
    st = None
    if task == "block":
        step = jtrain.make_sharded_train_block(jcfg, jax_lr(lr), mesh, jp,
                                               grad_clip_norm=clip)
    else:
        st = jax_opt_state(np_opt, params, jcfg, optimizer, jax_lr(lr),
                           mesh)
        step = jtrain.make_sharded_train_block_opt(
            jcfg, optimizer=optimizer, lr=jax_lr(lr), mesh=mesh,
            placement=jp, grad_clip_norm=clip)
    losses = []
    for b in blocks:
        args = [jax.device_put(jnp.asarray(b[k]), bs) for k in KEYS]
        if st is None:
            params, out = step(params, *args)
        else:
            (params, st), out = step(params, st, *args)
        losses += [float(x) for x in np.asarray(out)]
    return ranks, jax_result(params, st, jp, jcfg, losses), jp, tcfg


@pytest.mark.parametrize("what", CHECKS)
def test_gang_block_matches_jax(gang, what):
    ranks, want, jp, tcfg = gang
    got = gang_result(ranks, jp, tcfg)
    if what == "accumulators" and want["opt"] is None:  # SGD blocks
        assert got["opt"]["emb_acc"] is None
        return
    compare(got, want, what, ranks, jp)
    assert len(ranks[0]["losses"]) == K * BLOCKS
