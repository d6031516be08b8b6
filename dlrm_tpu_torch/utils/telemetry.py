"""Phase telemetry: the counterpart of ``dlrm_tpu/utils/telemetry.py``.

The reference wraps every forward stage in ``callback(cb, :sym, f, x...)``
and fires ``:sym_back`` on the reverse pass, and its training loop emits
``:start``, ``:grads_done``, ``:weight_update_done`` and
``:embedding_update_done``.  Two ways to see the phases here:

1. **Profiler scopes** (the production path): ``models/dlrm.py`` and the
   training step's gather run under :func:`phase_scope` s named
   ``lookup``, ``bottom_mlp``, ``interaction`` and ``top_mlp``;
   :func:`trace` records a ``torch.profiler`` trace in which they show.
   While no profiler records, a scope is a context that does nothing.
2. :class:`InstrumentedTrainer` (the diagnostic path): one SGD step as
   separate phases, the device synchronized after each, firing the
   reference's symbols in its order.  Slower per step (a sync a phase),
   but it gives the step-time breakdown.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from dlrm_tpu_torch.config import DLRMConfig


def phase_scope(name: str):
    """``record_function(name)`` while a profiler records, else a context
    that does nothing: entering a ``record_function`` costs microseconds
    of host time even when nothing records it."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def donothing(sym: str) -> None:  # reference default cb (utils.jl:27)
    del sym


class Recorder:
    """Timestamps every phase symbol; summarizes ns per phase.

    Attach after one warm-up step of the trainer: a phase's first run
    includes one-time costs (a kernel's build and load, allocator growth),
    so ``cmd_instrument`` passes :func:`donothing` for its first step."""

    def __init__(self):
        self.events: List[tuple] = []

    def __call__(self, sym: str) -> None:
        self.events.append((sym, time.perf_counter_ns()))

    def phase_durations(self) -> Dict[str, List[int]]:
        """ns between consecutive events, attributed to the later symbol."""
        out: Dict[str, List[int]] = collections.defaultdict(list)
        for (_, t0), (sym, t1) in zip(self.events, self.events[1:]):
            if sym != "start":
                out[sym].append(t1 - t0)
        return dict(out)

    def summary(self) -> Dict[str, float]:
        return {sym: sum(v) / len(v) / 1e6  # mean ms
                for sym, v in self.phase_durations().items()}


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace (CPU activity, and CUDA activity when a
    card is present) of the body, written as a Chrome trace into
    ``logdir``; the phase scopes show in it."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class InstrumentedTrainer:
    """One SGD step as separate phases with per-phase host timing.

    Each phase is synchronized before its callback fires.  Forward stages
    keep their autograd graphs; each ``_back`` phase takes the gradient of
    its stage from the one after it (``torch.autograd.grad``).  Numerics
    are those of ``train.train_step`` for f32 configs; the lookup pools
    every table plainly (``train_step`` rounds the small tables' rows to
    the compute dtype first, as the JAX package's one-hot path does, which
    differs under bf16 compute only).  Under ``interaction_impl="fused"``
    on the card the ``interaction`` phase launches the forward kernel and
    ``interaction_back`` the backward kernel.
    """

    def __init__(self, config: DLRMConfig, lr: float):
        from dlrm_tpu_torch.models.dlrm import _INTERACTIONS

        self.config = config
        self.lr = float(np.float32(lr))  # the JAX package's f32 lr
        self._interact = _INTERACTIONS[config.interaction_impl]

    def step(self, params: dict, batch: dict,
             cb: Callable[[str], None] = donothing) -> float:
        """One instrumented step on ``params``, in place; fires the
        reference's phase symbols and returns the loss."""
        from dlrm_tpu_torch.ops import embedding as emb_ops
        from dlrm_tpu_torch.ops.loss import bce_loss
        from dlrm_tpu_torch.ops.mlp import mlp_apply

        config, lr = self.config, self.lr
        emb = params["emb"]
        device = emb.device

        def sync(t=None):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return t

        def live(layers):
            return [{k: v.detach().requires_grad_() for k, v in l.items()}
                    for l in layers]

        def leaves(layers):
            return [l[k] for l in layers for k in ("w", "b")]

        dense, sparse, labels = (torch.as_tensor(batch[k]).to(device)
                                 for k in ("dense", "sparse", "labels"))
        cd = config.compute_dtype
        cd = None if cd == params["bottom"][0]["w"].dtype else cd
        cb("start")

        flat = emb_ops.translate_ids(sparse, config.table_offsets)
        pooled = sync(emb_ops.pool(emb_ops.gather_rows(emb, flat)))
        cb("lookup")
        bottom = live(params["bottom"])
        x = sync(mlp_apply(bottom, dense, final="relu", compute_dtype=cd))
        cb("bottom_mlp")
        x_in = x.detach().requires_grad_()
        p_in = pooled.detach().requires_grad_()
        z = sync(self._interact(x_in, p_in.to(x_in.dtype),
                                pad_to=config.interaction_pad_to))
        cb("interaction")
        top = live(params["top"])
        z_in = z.detach().requires_grad_()
        out = sync(mlp_apply(top, z_in, final="sigmoid",
                             compute_dtype=cd)[:, 0])
        cb("top_mlp")
        out_in = out.detach().requires_grad_()
        loss = sync(bce_loss(out_in, labels))
        cb("loss")

        (dout,) = torch.autograd.grad(loss, [out_in])
        sync()
        cb("loss_back")
        *dtop, dz = torch.autograd.grad(out, leaves(top) + [z_in], dout)
        sync()
        cb("top_mlp_back")
        dx, d_pooled = torch.autograd.grad(z, [x_in, p_in], dz)
        sync()
        cb("interaction_back")
        dbot = torch.autograd.grad(x, leaves(bottom), dx)
        sync()
        cb("bottom_mlp_back")
        cb("lookup_back")  # the compressed gradient is d_pooled itself
        cb("grads_done")

        with torch.no_grad():
            for p, g in zip(leaves(params["bottom"]) + leaves(params["top"]),
                            list(dbot) + dtop):
                p.sub_(g * lr)
            sync()
            cb("weight_update_done")
            if sparse.dim() == 3:  # multi-hot: a pooled grad per hit
                d_pooled = d_pooled[:, :, None, :].expand(
                    *sparse.shape, d_pooled.shape[-1])
            emb_ops.apply_sparse_sgd(emb, emb_ops.SparseGrad(
                ids=flat.reshape(-1),
                rows=d_pooled.reshape(-1, d_pooled.shape[-1])), lr)
            sync()
        cb("embedding_update_done")
        cb("update_done")
        return float(loss.detach())
