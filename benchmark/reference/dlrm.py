"""The DLRM of the configurations in plain PyTorch float32, with TF32 off:
the forward, the loss, its gradients, and the SGD and row-wise Adagrad
updates of the rows a batch touches.

It follows the configurations' stated model (``configs/*.json``): a bottom
MLP with ReLU on every layer; the dot interaction of the bottom output and
the tables' pooled rows (the Gram matrix's strictly-lower triangle in
row-major order, after the bottom output); a top MLP with ReLU on every
layer but the last, then a sigmoid; binary cross-entropy with each log
clamped at -100, whose gradient with respect to the prediction is the
epsilon-regularised quotient ``g / B * ((1 - y) / (1 - p + eps) - y / (p +
eps))``, eps the float32 machine epsilon.  Weights are stored (in, out).

The tables enter as the rows the batches touch: ``Rows`` keeps, per table,
the distinct row ids in ascending order and their values, so a step of a
full-size model needs only what its batches read.  At the per-table
hotness ``hot`` a batch's ids are (B, sum H), each table's H_t columns side
by side in table order; a table's pooled row is their rows' sum, added
column after column, and each hit takes the pooled row's gradient.

Beside the model: its dense leaf groups and their draw laws, the sizes the
program is held to, and its multiply-adds and matrix products, as
``reference/__init__.py`` sets out.

``precision(tf32=True)`` runs the same code in TF32, the control that the
comparison has to fail: every matrix product, forward and backward, takes
its operands rounded to TF32's 10-bit mantissa (round to nearest even),
as the card's TF32 products do, so the control reads alike on any device.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

EPS = float(torch.finfo(torch.float32).eps)
_TF32 = [False]

# configuration key -> the program's DLRMConfig attribute
PROGRAM_KEYS = {"table_sizes": "table_sizes", "feature_size": "feature_size",
                "bottom_mlp": "bottom_mlp_sizes", "top_mlp": "top_mlp_sizes",
                "n_hot": "n_hot"}


# -- the model's shapes, its dense leaves and its counts ----------------------

def interaction_features(cfg: dict) -> int:
    """F: the bottom MLP's output and the tables' rows re-chunked to its
    width."""
    d = cfg["bottom_mlp"][-1]
    return len(cfg["table_sizes"]) * cfg["feature_size"] // d + 1


def num_pairs(cfg: dict) -> int:
    f = interaction_features(cfg)
    return f * (f - 1) // 2


def mlp_layers(cfg: dict) -> List[Tuple[str, int, int]]:
    """(tower, in, out) of every dense layer; the top tower's input is the
    bottom output and the pairs."""
    bottom = cfg["bottom_mlp"]
    top = [bottom[-1] + num_pairs(cfg)] + list(cfg["top_mlp"])
    return ([("bottom", a, b) for a, b in zip(bottom, bottom[1:])]
            + [("top", a, b) for a, b in zip(top, top[1:])])


def dense_groups(cfg: dict):
    """The towers in draw order: each layer's weight ~ N(0, 2 / (in +
    out)), then its bias ~ N(0, 1 / out)."""
    out = {"bottom": [], "top": []}
    for tower, a, b in mlp_layers(cfg):
        out[tower].append({"w": ((a, b), math.sqrt(2.0 / (a + b))),
                           "b": ((b,), math.sqrt(1.0 / b))})
    return list(out.items())


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one example's forward: the MLPs and the pair dots."""
    return (sum(a * b for _, a, b in mlp_layers(cfg))
            + num_pairs(cfg) * cfg["bottom_mlp"][-1])


def gemms(cfg: dict, batch: int, train: bool) -> List[Tuple[int, int, int]]:
    """(m, k, n) of every matrix product the step needs: each layer's
    forward; in training each weight's gradient and each layer's input
    gradient but the first bottom layer's (the dense features take none)."""
    out = []
    for i, (_, a, b) in enumerate(mlp_layers(cfg)):
        out.append((batch, a, b))
        if train:
            out.append((a, batch, b))       # dW = x^T dy
            if i:
                out.append((batch, b, a))   # dx = dy W^T
    return out


# -- the model in plain f32 ----------------------------------------------------


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in f32 (``tf32=False``) or TF32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, _TF32[0])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _TF32[0] = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _TF32[0]) = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to 10 mantissa bits, to nearest even."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return (torch.matmul(g, round_tf32(b).transpose(-1, -2)),
                torch.matmul(round_tf32(a).transpose(-1, -2), g))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Tf32Matmul.apply(a, b) if _TF32[0] else torch.matmul(a, b)


def _mlp(layers, x: torch.Tensor, last: str) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = matmul(x, layer["w"]) + layer["b"]
        if i < len(layers) - 1 or last == "relu":
            x = torch.relu(x)
        else:
            x = torch.sigmoid(x)
    return x


def interact(x: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """(B, d) and (B, T, D) -> (B, d + F(F-1)/2), F = T * D / d + 1."""
    b, d = x.shape
    t = torch.cat([x[:, None, :], pooled.reshape(b, -1, d)], dim=1)
    z = matmul(t, t.transpose(1, 2))
    f = t.shape[1]
    i, j = torch.tril_indices(f, f, offset=-1, device=x.device)
    return torch.cat([x, z[:, i, j]], dim=1)


def forward(dense_params: dict, pooled: torch.Tensor, dense: torch.Tensor
            ) -> torch.Tensor:
    """Click probabilities (B,)."""
    x = _mlp(dense_params["bottom"], dense, "relu")
    return _mlp(dense_params["top"], interact(x, pooled), "sigmoid")[:, 0]


def bce(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (-y * torch.clamp(torch.log(p), min=-100.0)
            + (y - 1.0) * torch.clamp(torch.log(1.0 - p), min=-100.0)).mean()


def bce_grad(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((1.0 - y) / (1.0 - p + EPS) - y / (p + EPS)) / p.numel()


def leaves(dense_params: dict) -> List[torch.Tensor]:
    """Every dense leaf, group by group, layer by layer, in draw order."""
    return [leaf for layers in dense_params.values() for layer in layers
            for leaf in layer.values()]


def _copy(dense_params: dict, fn) -> dict:
    return {group: [{k: fn(v) for k, v in layer.items()} for layer in layers]
            for group, layers in dense_params.items()}


def loss_and_grads(dense_params: dict, pooled: torch.Tensor,
                   dense: torch.Tensor, labels: torch.Tensor):
    """(loss, the dense leaves' gradients, the pooled rows' gradient)."""
    live = _copy(dense_params, lambda v: v.detach().requires_grad_())
    pooled = pooled.detach().requires_grad_()
    p = forward(live, pooled, dense)
    pd = p.detach()
    grads = torch.autograd.grad(p, leaves(live) + [pooled],
                                grad_outputs=bce_grad(pd, labels))
    return bce(pd, labels), list(grads[:-1]), grads[-1]


def _sum_columns(parts) -> torch.Tensor:
    """The columns' rows added one after another, as a pooled row."""
    x = parts[0]
    for part in parts[1:]:
        x = x + part
    return x


def _starts(hot: Sequence[int]) -> List[int]:
    """Each table's first column in a batch's ids, and the width last."""
    return [0, *itertools.accumulate(hot)]


def pool(rows: torch.Tensor, hot: Sequence[int]) -> torch.Tensor:
    """A batch's looked-up rows (B, sum H, D), each table's ``hot[t]`` side
    by side, sum-pooled per table to (B, T, D)."""
    s = _starts(hot)
    if rows.shape[1] != s[-1]:
        raise ValueError(f"{rows.shape[1]} looked-up rows an example for "
                         f"the hotness {list(hot)}")
    return torch.stack([_sum_columns([rows[:, c]
                                      for c in range(s[k], s[k + 1])])
                        for k in range(len(hot))], dim=1)


class Rows:
    """The rows of each table that some batches touch: ``ids[t]`` ascending
    distinct ids, ``values[t]`` (U_t, D) f32, and an optimizer accumulator
    ``acc[t]`` (U_t,) for row-wise Adagrad; ``hot[t]`` columns of table
    ``t`` in a batch (``hot`` None: one a table)."""

    def __init__(self, ids: Sequence[torch.Tensor],
                 values: Sequence[torch.Tensor],
                 hot: Optional[Sequence[int]] = None):
        self.ids = list(ids)
        self.values = [v.float().clone() for v in values]
        self.acc = [torch.zeros(v.shape[0], dtype=torch.float32,
                                device=v.device) for v in self.values]
        self.hot = [1] * len(self.ids) if hot is None else list(hot)
        if len(self.hot) != len(self.ids):
            raise ValueError(f"hotness {self.hot} for {len(self.ids)} tables")

    def index(self, sparse: torch.Tensor) -> List[torch.Tensor]:
        """Positions (B, H_t) of a batch's ids (B, sum H) in each table's
        ``ids``."""
        s = _starts(self.hot)
        if sparse.shape[1] != s[-1]:
            raise ValueError(f"a batch of {sparse.shape[1]} id columns for "
                             f"{len(self.ids)} tables at hotness {self.hot}")
        out = []
        for t, ids in enumerate(self.ids):
            col = sparse[:, s[t]:s[t + 1]].to(ids.dtype).contiguous()
            pos = torch.searchsorted(ids, col)
            if not bool((ids[pos.clamp(max=ids.numel() - 1)] == col).all()):
                raise ValueError(f"table {t}: a batch id is not among the "
                                 f"rows held")
            out.append(pos)
        return out

    def pooled(self, pos: List[torch.Tensor]) -> torch.Tensor:
        """(B, T, D): each table's rows of its columns, summed."""
        return torch.stack([_sum_columns([v[p[:, j]]
                                          for j in range(p.shape[1])])
                            for v, p in zip(self.values, pos)], dim=1)


def summed_row_grads(d_pooled: torch.Tensor, pos: List[torch.Tensor],
                     rows: Rows) -> List[torch.Tensor]:
    """Each table's gradient (U_t, D): a row's hits summed, each hit of a
    table taking its pooled row's gradient."""
    out = []
    for t, p in enumerate(pos):
        g = torch.zeros_like(rows.values[t])
        h = p.shape[1]
        src = d_pooled[:, t, None].expand(-1, h, -1).reshape(-1, g.shape[1])
        g.index_add_(0, p.reshape(-1), src)
        out.append(g)
    return out


class Trainer:
    """Training steps of the reference: ``job`` gives ``lr``,
    ``dense_optimizer`` and ``sparse_optimizer`` (``sgd``, or ``adagrad``
    and ``rowwise_adagrad``, from a zero accumulator with ``eps``).

    Adagrad: ``acc += g^2; p -= lr * g / sqrt(acc + eps)``, nothing where
    acc is 0.  Row-wise Adagrad keeps one accumulator a row, ``acc +=
    mean_D(g^2)``, with the row's summed gradient.  SGD: ``p -= lr * g``."""

    def __init__(self, dense_params: dict, rows: Rows, job: dict,
                 half_batch: bool = False):
        self.params = _copy(dense_params, lambda v: v.float().clone())
        self.rows, self.job = rows, job
        self.dense_acc = [torch.zeros_like(p) for p in leaves(self.params)]
        self.lr = float(torch.tensor(float(job["lr"]), dtype=torch.float32))
        self.eps = float(job.get("eps", 1e-10))
        self.half_batch = half_batch   # a fault: the mean over half

    def _scale(self, acc: torch.Tensor) -> torch.Tensor:
        return torch.where(acc > 0, torch.rsqrt(acc + self.eps),
                           torch.zeros_like(acc))

    def step(self, batch: Dict[str, torch.Tensor]):
        """One step; returns (loss, dense gradients, tables' summed
        gradients), the gradients as the optimizer gets them."""
        dense, sparse, labels = batch["dense"], batch["sparse"], \
            batch["labels"]
        if self.half_batch:
            h = dense.shape[0] // 2
            dense, sparse, labels = dense[:h], sparse[:h], labels[:h]
        pos = self.rows.index(sparse)
        loss, dgrads, d_pooled = loss_and_grads(
            self.params, self.rows.pooled(pos), dense.float(),
            labels.float())
        tgrads = summed_row_grads(d_pooled, pos, self.rows)
        with torch.no_grad():
            dense_opt = self.job["dense_optimizer"]
            for p, g, acc in zip(leaves(self.params), dgrads, self.dense_acc):
                if dense_opt == "sgd":
                    p -= self.lr * g
                elif dense_opt == "adagrad":
                    acc += g * g
                    p -= self.lr * g * self._scale(acc)
                else:
                    raise ValueError(dense_opt)
            sparse_opt = self.job["sparse_optimizer"]
            for t, g in enumerate(tgrads):
                v, acc = self.rows.values[t], self.rows.acc[t]
                touched = torch.zeros(v.shape[0], dtype=torch.bool,
                                      device=v.device)
                touched[pos[t]] = True
                if sparse_opt == "sgd":
                    v[touched] -= self.lr * g[touched]
                elif sparse_opt == "rowwise_adagrad":
                    acc[touched] += (g[touched] * g[touched]).mean(dim=1)
                    v[touched] -= self.lr * g[touched] * self._scale(
                        acc[touched])[:, None]
                else:
                    raise ValueError(sparse_opt)
        return float(loss), dgrads, tgrads


def score(dense_params: dict, pooled: torch.Tensor, dense: torch.Tensor
          ) -> torch.Tensor:
    """Click probabilities of a batch."""
    with torch.no_grad():
        return forward(dense_params, pooled, dense.float())
