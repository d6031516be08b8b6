"""Phase telemetry: the counterpart of ``dlrm_tpu/utils/telemetry.py``.

The reference wraps every forward stage in ``callback(cb, :sym, f, x...)``
and fires ``:sym_back`` on the reverse pass, and its training loop emits
``:start``, ``:grads_done``, ``:weight_update_done`` and
``:embedding_update_done``.  Two ways to see the phases here:

1. **Profiler spans and counters** (the production path).  A span is a
   ``record_function`` range opened by :func:`phase_scope` (or, on the
   thread that runs a backward, by :class:`BackwardSpans`), so it lies on
   the profiler's clock beside the device's activity; this module keeps no
   timestamps of its own.  While no profiler records on the calling
   thread, a span is a context that does nothing and a count is dropped:
   each costs one ``torch.autograd._profiler_enabled()`` call.

   ==========================  =============================================
   span                        where
   ==========================  =============================================
   ``lookup``                  the gather and pool (``ops/embedding.py``,
                               ``models/dlrm.py``, the tiered and sharded
                               steps)
   ``bottom_mlp``,             the forward's stages (``models/dlrm.py``)
   ``interaction``,
   ``top_mlp``, ``loss``
   ``loss.bwd``,               the backward's stages, on the thread that
   ``top_mlp.bwd``,            runs it (``models/dlrm.py``; the fused
   ``interaction.bwd``,        interaction's inside its backward,
   ``bottom_mlp.bwd``          ``ops/interaction_fused.py``)
   ``autograd.bwd``            the caller's ``torch.autograd.grad``: what
                               the engine does outside the stages' spans
   ``grad_split``              the per-hit gradient split by table group or
                               tier (``ops/embedding.split_by_tables``,
                               ``parallel/host_tier.py``)
   ``dense_apply``             ``train/optim.apply_dense``
   ``sparse_update``           the device tables' updates (``train/train.py``
                               and the sharded step)
   ``dedup``                   ``ops/embedding.sum_duplicates``: ``unique``
                               and the duplicates' sum (a host sync on
                               CUDA); ``ops/embedding.sort_hits``: the
                               sorted segment sum's stable sort (no sync)
   ``lookup_host_tier``,       the host tier's gather, update (with its
   ``host_tier_update``,       dedup) and the pipelined step's gather of the
   ``host_tier_prefetch_next`` next batch (``parallel/host_tier.py``)
   ``prefetch.take``           the consumer's wait for and take of a batch
                               (``data/prefetch._ahead``)
   ``score_batch.h2d``,        ``run.score_batch``'s two copies to the card
   ``score_batch.readback``    and the scores' copy back
   ==========================  =============================================

   The sharded path adds its collectives' spans (``parallel/embedding.py``).
   Counters (:func:`count`, read by :func:`counters`) add up host-known
   quantities, never a device value: ``host_tier.gather_bytes`` and
   ``host_tier.update_bytes`` (the bytes the host tier's kernels move, a
   row a hit; an update reads and writes its row), ``prefetch.takes`` and
   ``prefetch.empty`` (the takes that found no batch queued),
   ``dense_apply.launches`` (the kernels ``train/optim.apply_dense``
   launched on the card), ``sparse_update.hits`` and
   ``sparse_update.fused_hits`` (``train/optim.count_hits``: the device
   tables' hits that reach an update on the card, and those the sorted
   segment sum takes).
   :func:`trace` records a ``torch.profiler`` trace with the spans and the
   counters of its stretch.
2. :class:`InstrumentedTrainer` (the diagnostic path): one SGD step as
   separate phases, the device synchronized after each, firing the
   reference's symbols in its order.  Slower per step (a sync a phase),
   but it gives the step-time breakdown.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from dlrm_tpu_torch.config import DLRMConfig


def recording() -> bool:
    """Whether a profiler records on the calling thread (the gate of every
    span and count)."""
    return torch.autograd._profiler_enabled()


def phase_scope(name: str):
    """``record_function(name)`` while a profiler records, else a context
    that does nothing: entering a ``record_function`` costs microseconds
    of host time even when nothing records it."""
    if recording():
        return record_function(name)
    return contextlib.nullcontext()


_COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records on the
    calling thread; otherwise nothing.  ``n`` is known on the host (a
    shape, a flag), never read from the device."""
    if recording():
        with _COUNTS_LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()


class _BackwardMark(torch.autograd.Function):
    """The identity; its backward closes one span of a
    :class:`BackwardSpans` and opens another, on the thread that runs it."""

    @staticmethod
    def forward(ctx, x, spans, close, open_):
        ctx.spans, ctx.close, ctx.open = spans, close, open_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.spans.switch(ctx.close, ctx.open)
        return g, None, None, None


class BackwardSpans:
    """Spans of a backward's stages, made from marks in the forward.

    A span around ``torch.autograd.grad`` names nothing the backward does:
    on CUDA it runs on the autograd engine's device thread.  So each stage
    boundary of the forward gets a mark (:meth:`mark`, an identity node)
    whose backward, reached when the gradient at that boundary is done,
    closes the span of the stage just finished and opens the next one's on
    the thread running the backward.  Spans still open when the backward
    ends are closed then.  Gradients pass through unchanged.  An inactive
    one's marks return their input: nothing is added to the graph."""

    def __init__(self, active: bool = True):
        self.active = active
        self.open: Dict[str, object] = {}

    def mark(self, x: torch.Tensor, close: Optional[str] = None,
             open: Optional[str] = None) -> torch.Tensor:
        if not (self.active and x.requires_grad):
            return x
        return _BackwardMark.apply(x, self, close, open)

    def switch(self, close: Optional[str], open_: Optional[str]) -> None:
        if close in self.open:
            torch.ops.profiler._record_function_exit(self.open.pop(close))
        if open_ is not None and open_ not in self.open and recording():
            if not self.open:
                torch.autograd.Variable._execution_engine.queue_callback(
                    self.close_all)
            self.open[open_] = \
                torch.ops.profiler._record_function_enter_new(open_, None)

    def close_all(self) -> None:
        for handle in reversed(list(self.open.values())):
            torch.ops.profiler._record_function_exit(handle)
        self.open.clear()


NO_BACKWARD_SPANS = BackwardSpans(active=False)


def backward_spans() -> BackwardSpans:
    """The :class:`BackwardSpans` of a forward: active when its backward
    is for a profiler to see (grad mode on, a profiler recording), else
    inactive, so that with tracing off nothing is added to the graph."""
    if torch.is_grad_enabled() and recording():
        return BackwardSpans()
    return NO_BACKWARD_SPANS


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
    ``logdir``; the spans show in it, and the counters of the body (reset
    at its start) under the trace's ``counters`` key."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    reset_counters()
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.add_metadata_json("counters", json.dumps(counters()))
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
