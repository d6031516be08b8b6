"""PyTorch-fixture parity harness: the counterpart of
``dlrm_tpu/validation.py``.

Load a PyTorch-exported model and inputs from HDF5 (``io/hdf5.py``), check
the inference loss and scores, take ONE SGD step at lr 10, and hold the
updated weights, biases and tables to the file's ``update_*`` datasets.
Both sides start from the same loaded parameters and apply ``p - lr * g``
with the same lr, so this is a per-layer gradient check.  The file's
original and updated values must differ, for weights, biases and tables
alike (a guard against a trivial pass).
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

from dlrm_tpu_torch.io import hdf5 as h5io
from dlrm_tpu_torch.io.convert import params_from_numpy, params_to_numpy
from dlrm_tpu_torch.models import dlrm as model_lib
from dlrm_tpu_torch.ops.loss import bce_loss
from dlrm_tpu_torch.train.train import make_train_step


def _check(name: str, a, b, atol: float, rtol: float, report: Dict) -> None:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    ok = np.allclose(a, b, atol=atol, rtol=rtol)
    report[name] = {"max_abs_err": err, "ok": bool(ok)}
    if not ok:
        raise AssertionError(f"parity failure at {name}: max|err|={err}")


def validate(path: str, learning_rate: float = 10.0, atol: float = 1e-4,
             rtol: float = 1e-4, device="cuda") -> Dict:
    """The parity protocol against one fixture, on ``device``; returns a
    report of per-check max errors and raises AssertionError on any
    mismatch.  TF32 is off for its duration: parity with a float32 dump
    must not depend on the ambient matmul precision."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _validate(path, learning_rate, atol, rtol,
                         torch.device(device))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _validate(path: str, learning_rate: float, atol: float, rtol: float,
              device: torch.device) -> Dict:
    np_params, config = h5io.load_params(path)
    inputs = h5io.load_inputs(path)
    ref = h5io.load_reference_outputs(path)
    report: Dict = {}

    params = params_from_numpy(np_params, config, device)
    dense, sparse, labels = (torch.from_numpy(inputs[k]).to(device)
                             for k in ("dense", "sparse", "labels"))

    # inference
    with torch.no_grad():
        out = model_lib.forward(params, dense, sparse, config)
        loss = bce_loss(out, labels)
    _check("loss", loss.cpu(), ref["loss"], atol, rtol, report)
    _check("mlp_top", out.cpu()[:, None], ref["mlp_top"], atol, rtol, report)

    # one SGD step, in place (on the CPU the tensors share memory with
    # their numpy views: keep a copy of the originals)
    original = copy.deepcopy(params_to_numpy(params))
    make_train_step(config, learning_rate)(params, dense, sparse, labels)
    new = params_to_numpy(params)

    for key, hprefix in (("top", "update_top"), ("bottom", "update_bot")):
        layer_ids = sorted({int(k.split("_")[-1].split(".")[0])
                            for k in ref if k.startswith(hprefix)})
        if len(layer_ids) != len(new[key]):
            raise AssertionError(f"{key}: the file has updates of layers "
                                 f"{layer_ids}, the model {len(new[key])} "
                                 "layers")
        for i, lid in enumerate(layer_ids):
            upd_w = ref[f"{hprefix}_{lid}.weight"].T  # (out,in)->(in,out)
            upd_b = ref[f"{hprefix}_{lid}.bias"]
            for what, upd, old in (("weight", upd_w, original[key][i]["w"]),
                                   ("bias", upd_b, original[key][i]["b"])):
                if np.allclose(upd, old):
                    raise AssertionError(
                        f"{key} layer {i}: PyTorch original {what} == "
                        "updated (trivial pass guard)")
            _check(f"{key}.{i}.weight", new[key][i]["w"], upd_w, atol, rtol,
                   report)
            _check(f"{key}.{i}.bias", new[key][i]["b"], upd_b, atol, rtol,
                   report)

    for t in range(config.num_tables):
        off, n = config.table_offsets[t], config.table_sizes[t]
        upd = ref[f"update_emb_{t}"]
        if np.allclose(upd, original["emb"][off:off + n]):
            raise AssertionError(
                f"table {t}: PyTorch original == updated (trivial pass)")
        _check(f"emb_{t}", new["emb"][off:off + n], upd, atol, rtol, report)
    return report
