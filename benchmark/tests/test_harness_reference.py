"""The plain reference held against the port at tiny sizes on the CPU:
scores, and three training steps of SGD and of two-tier row-wise Adagrad.
The reference is given the same inputs the port is given and works out
the rest again."""

import copy
import math

import pytest
import torch

from benchmark import program
from benchmark.reference import dlrm as ref

SIZES = [3, 40, 7, 300, 90]
FS = 8


def _config():
    return {"model": "dlrm", "table_sizes": SIZES, "feature_size": FS,
            "num_dense": 13, "bottom_mlp": [13, 16, FS], "top_mlp": [32, 1]}


GROUPS = ref.dense_groups(_config())


def _port_config(impl="gram"):
    from dlrm_tpu_torch.config import DLRMConfig
    c = _config()
    return DLRMConfig(bottom_mlp_sizes=tuple(c["bottom_mlp"]),
                      top_mlp_sizes=tuple(c["top_mlp"]), feature_size=FS,
                      table_sizes=tuple(SIZES), interaction_impl=impl)


def _draw(seed):
    g = torch.Generator().manual_seed(seed)
    dense = program.draw_dense(g, _config(), "cpu")
    emb = torch.empty((sum(SIZES), FS))
    store = program.TableStore([(emb, sum(SIZES[:t]))
                                for t in range(len(SIZES))])
    program.fill_tables(g, store, SIZES, "cpu")
    b = 64
    batches = [{"dense": torch.randn((b, 13), generator=g),
                "sparse": torch.stack([torch.randint(0, n, (b,), generator=g)
                                       for n in SIZES], 1).to(torch.int32),
                "labels": (torch.rand(b, generator=g) < 0.4).float()}
               for _ in range(3)]
    return dense, emb, store, batches


def _rows(store, batches):
    ids = [torch.unique(torch.cat([b["sparse"][:, t].long()
                                   for b in batches]))
           for t in range(len(SIZES))]
    return ref.Rows(ids, [store.read(t, i) for t, i in enumerate(ids)])


@pytest.mark.parametrize("impl", ["gram", "fused"])
def test_scores_match_the_port(impl):
    from dlrm_tpu_torch.models.dlrm import forward
    dense, emb, store, batches = _draw(1)
    b = batches[0]
    got = forward({**dense, "emb": emb}, b["dense"], b["sparse"],
                  _port_config(impl))
    rows = _rows(store, [b])
    want = ref.score(dense, rows.pooled(rows.index(b["sparse"])),
                     b["dense"])
    assert torch.allclose(got, want, rtol=0, atol=1e-6)


def _close(a, b, tol):
    return float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1e-30)


def test_sgd_steps_match_the_port():
    from dlrm_tpu_torch.train.train import train_step
    dense, emb, store, batches = _draw(2)
    rows = _rows(store, batches)
    job = {"lr": 0.1, "dense_optimizer": "sgd", "sparse_optimizer": "sgd"}
    trainer = ref.Trainer(dense, rows, job)
    params = {**copy.deepcopy(dense), "emb": emb}
    for b in batches:
        lp = float(train_step(params, b["dense"], b["sparse"], b["labels"],
                              config=_port_config(), lr=0.1))
        lr_, _, _ = trainer.step(b)
        assert math.isclose(lp, lr_, rel_tol=1e-6)
    for a, w in zip(program.dense_leaves(params, GROUPS),
                    ref.leaves(trainer.params)):
        assert _close(a, w, 1e-5)
    for t, ids in enumerate(rows.ids):
        assert _close(store.read(t, ids), rows.values[t], 1e-5)


def test_two_tier_rowwise_adagrad_steps_match_the_port():
    from dlrm_tpu_torch.parallel import host_tier as ht
    dense, emb, _, batches = _draw(3)
    cfg = _port_config()
    plan = ht.plan_tiers(cfg, (sum(SIZES) - 300) * FS * 4)
    assert plan.host_tables == (3,)
    dev, host = ht.split_tiers(emb, plan, cfg)
    params = {**copy.deepcopy(dense), "emb": ht.TieredEmb(dev, host, plan)}
    store = program._store({"dev": dev, "host": host}, plan, SIZES)
    rows = _rows(store, batches)
    job = {"lr": 0.01, "eps": 1e-10, "dense_optimizer": "adagrad",
           "sparse_optimizer": "rowwise_adagrad"}
    trainer = ref.Trainer(dense, rows, job)
    opt = ht.init_tiered_opt_state(params, config=cfg,
                                   optimizer="rowwise_adagrad")
    for b in batches:
        lp = float(ht.tiered_train_step_opt(
            params, opt, b["dense"], b["sparse"], b["labels"], config=cfg,
            optimizer="rowwise_adagrad", lr=0.01))
        lr_, _, _ = trainer.step(b)
        assert math.isclose(lp, lr_, rel_tol=1e-6)
    for a, w in zip(program.dense_leaves(params, GROUPS),
                    ref.leaves(trainer.params)):
        assert _close(a, w, 1e-5)
    accs = program._store({"dev": opt["dev_acc"].view(-1, 1),
                           "host": opt["host_acc"].view(-1, 1)}, plan, SIZES)
    for t, ids in enumerate(rows.ids):
        assert _close(store.read(t, ids), rows.values[t], 1e-5)
        assert _close(accs.read(t, ids)[:, 0], rows.acc[t], 1e-5)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -2.5 - 2**-12, 1e-30])
    y = ref.round_tf32(x)
    assert y.tolist()[:3] == [1.0, 1.0, 1 + 2**-9]
    assert y[3] == -2.5
    bits = y.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0


def test_the_tf32_control_is_farther_from_the_reference_than_the_port():
    from dlrm_tpu_torch.models.dlrm import forward
    dense, emb, store, batches = _draw(4)
    b = batches[0]
    rows = _rows(store, [b])
    pooled = rows.pooled(rows.index(b["sparse"]))
    want = ref.score(dense, pooled, b["dense"])
    with ref.precision(True):
        ctl = ref.score(dense, pooled, b["dense"])
    got = forward({**dense, "emb": emb}, b["dense"], b["sparse"],
                  _port_config("fused"))
    assert float((ctl - want).abs().max()) > \
        100 * float((got - want).abs().max()) + 1e-7


@pytest.mark.chip
def test_the_tf32_control_fails_on_the_card(card):
    """On the card at a width of the cells: the port's scores stay within
    the cells' score limit of the reference, TF32's do not."""
    import json
    from pathlib import Path

    from dlrm_tpu_torch.models.dlrm import forward
    from dlrm_tpu_torch.config import DLRMConfig

    limit = json.loads((Path(__file__).resolve().parents[1] / "cells" /
                        "kaggle-fs128.serve-b16384.zipf.json").read_text()
                       )["limits"]["score_gap"]
    g = torch.Generator(card).manual_seed(9)
    cfg = {"model": "dlrm", "bottom_mlp": [13, 512, 256, 128],
           "top_mlp": [1024, 1024, 512, 256, 1],
           "table_sizes": [1000] * 26, "feature_size": 128}
    dense = program.draw_dense(g, cfg, card)
    emb = (torch.rand((26000, 128), generator=g, device=card) - 0.5) * 0.06
    sparse = torch.randint(0, 1000, (4096, 26), generator=g, device=card,
                           dtype=torch.int32)
    x = torch.randn((4096, 13), generator=g, device=card)
    port = DLRMConfig(bottom_mlp_sizes=(13, 512, 256, 128),
                      top_mlp_sizes=(1024, 1024, 512, 256, 1),
                      feature_size=128, table_sizes=(1000,) * 26,
                      interaction_impl="fused")
    got = forward({**dense, "emb": emb}, x, sparse, port)
    pooled = emb[sparse.long() + torch.arange(26, device=card) * 1000]
    want = ref.score(dense, pooled, x)
    with ref.precision(True):
        ctl = ref.score(dense, pooled, x)
    assert float((got - want).abs().max()) <= limit
    assert float((ctl - want).abs().max()) > limit
