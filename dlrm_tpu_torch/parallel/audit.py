"""Count the collectives a sharded step issues, and price them on the
links: the port's counterpart of the JAX package's HLO collective audit
(``scaling_audit.py`` at the repo root).

:class:`CollectiveCounter` is a ``TorchDispatchMode``: every
``torch.distributed`` collective reaches the dispatcher as a ``c10d`` op,
whatever Python name called it (``parallel/embedding.py`` binds
``_all_gather`` / ``_reduce_scatter`` at import, so patching
``torch.distributed`` would miss them), and the counter records each one
that runs under it: the op kind, its dtype, the bytes of its result, the
size of its group and the mesh axis the group rides (``"d"``, the table
axis; ``"h"``, the data-only DCN axis of a 2-D mesh; ``"mesh"``, the
whole gang).  The count is of what was issued, never of what a placement
says should be.

:func:`link_bytes` is the ring / edge cost model the JAX audit prices
with: the bytes one rank sends over its links for one collective.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from dlrm_tpu_torch.data.synthetic import random_batch
from dlrm_tpu_torch.parallel.embedding import draw_sharded_params
from dlrm_tpu_torch.parallel.mesh import mesh_rank
from dlrm_tpu_torch.train.train import make_sharded_train_step

# the c10d ops the counter models, by the kind the JAX audit names them
_KINDS = {
    "allreduce_": "all-reduce",
    "_allgather_base_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
}

# dtype names as an HLO type string spells them
_DTYPE_NAMES = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float64: "f64", torch.int32: "s32", torch.int64: "s64",
    torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as issued: ``kind`` as the JAX audit names it,
    ``dtype`` (``"f32"``, ``"bf16"``, ``"s32"`` ...), ``result_bytes`` (the
    gathered buffer of an all-gather, the shard of a reduce-scatter, the
    receive buffer of an all-to-all, the reduced buffer of an all-reduce),
    ``group_size`` ranks, ``axis`` the mesh axis of its group."""

    kind: str
    dtype: str
    result_bytes: int
    group_size: int
    axis: str

    @property
    def link_bytes(self) -> float:
        return link_bytes(self.kind, self.result_bytes, self.group_size)


def link_bytes(kind: str, result_bytes: int, n: int) -> float:
    """Per-rank link traffic for one collective (ring / edge cost model).

    all-gather: the result is the whole gathered buffer; each rank
    receives (n-1)/n of it.  reduce-scatter: the result is the 1/n shard;
    each rank sends and receives (n-1) shards.  all-reduce = reduce-scatter
    + all-gather over the whole buffer: 2(n-1)/n of the result.
    all-to-all: the result is this rank's receive buffer; (n-1)/n of it
    crossed a link.  collective-permute: the whole result crossed one
    link."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (n - 1) / n
    if kind == "all-to-all":
        return result_bytes * (n - 1) / n
    return float(result_bytes)  # collective-permute


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CollectiveCounter(TorchDispatchMode):
    """``with CollectiveCounter(mesh) as c: step(...)``: ``c.records`` is
    the list of :class:`Collective` the step issued, in issue order.  A
    c10d op the audit does not model (a broadcast, a list all-gather, a
    barrier) raises, so that no traffic goes uncounted.  ``mesh``: the
    ``DeviceMesh`` whose axes name the groups; a group on none of its axes
    is ``"mesh"`` when it is the whole gang."""

    def __init__(self, mesh):
        super().__init__()
        self.records: List[Collective] = []
        self._axes = [(name, mesh.get_group(name))
                      for name in mesh.mesh_dim_names]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in ("c10d", "_c10d_functional"):
            self.records.append(self._record(func, args))
        return func(*args, **kwargs)

    def _axis(self, group) -> str:
        for name, g in self._axes:
            if group == g:
                return name
        if group == dist.group.WORLD:
            return "mesh"
        raise ValueError(f"a collective on a group of ranks "
                         f"{dist.get_process_group_ranks(group)} that is "
                         f"neither an axis of the mesh nor the whole gang")

    def _record(self, func, args) -> Collective:
        op = func._schema.name.split("::")[-1]
        if func.namespace != "c10d" or op not in _KINDS:
            raise NotImplementedError(
                f"the step issued {func}, which the audit does not model; "
                f"extend parallel/audit.py before trusting its totals")
        schema = func._schema.arguments
        group = next(dist.ProcessGroup.unbox(a) for a, s in zip(args, schema)
                     if "ProcessGroup" in str(s.type))
        # allreduce_ takes a list of tensors, reduced in place; the others
        # write their result into their first argument
        tensors = args[0] if isinstance(args[0], (list, tuple)) \
            else [args[0]]
        dtypes = {_DTYPE_NAMES[t.dtype] for t in tensors}
        if len(dtypes) != 1:
            raise NotImplementedError(f"{op} over the dtypes {dtypes}")
        return Collective(_KINDS[op], dtypes.pop(),
                          sum(_nbytes(t) for t in tensors), group.size(),
                          self._axis(group))


def count_collectives(mesh, fn, *args, **kwargs) -> Tuple[object,
                                                          List[Collective]]:
    """``(fn(*args, **kwargs), the collectives it issued)``."""
    with CollectiveCounter(mesh) as counter:
        out = fn(*args, **kwargs)
    return out, counter.records


def audit_step(config, placement, mesh, batch_per_rank: int, *,
               seed: int = 0, lr: float = 0.1,
               device="cpu") -> List[Collective]:
    """The collectives of one ``train.make_sharded_train_step`` step on
    ``mesh`` (table axis ``"d"``): this rank's shard drawn from
    ``config.seed`` (``embedding.draw_sharded_params``), its own
    ``batch_per_rank`` rows drawn from ``seed`` and its place in the
    mesh, int32 ids."""
    params = draw_sharded_params(
        torch.Generator(device).manual_seed(config.seed), placement, config,
        mesh.get_local_rank("d"), device)
    batch = random_batch(np.random.default_rng([seed, mesh_rank(mesh)]),
                         config, batch_per_rank)
    step = make_sharded_train_step(config, lr, mesh, placement,
                                   local_batch=True)
    loss, records = count_collectives(
        mesh, step, params, *(torch.as_tensor(batch[k]).to(device)
                              for k in ("dense", "sparse", "labels")))
    if not torch.isfinite(loss):
        raise FloatingPointError(f"the audited step's loss is {loss}")
    return records


def by_kind(records) -> Dict[str, Tuple[int, float]]:
    """``{kind: (count, link bytes a rank)}``."""
    out = defaultdict(lambda: [0, 0.0])
    for c in records:
        out[c.kind][0] += 1
        out[c.kind][1] += c.link_bytes
    return {k: tuple(v) for k, v in sorted(out.items())}


def by_axis(records) -> Dict[str, Dict[str, Tuple[int, float]]]:
    """``{axis: {kind: (count, link bytes a rank)}}``."""
    axes = defaultdict(list)
    for c in records:
        axes[c.axis].append(c)
    return {axis: by_kind(rs) for axis, rs in sorted(axes.items())}
