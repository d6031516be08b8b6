"""The MLPs' matrix products (``ops/mlp.py``): their least time
(``counts.gemm_bound_s``) over the time of the gemm and gemv kernels, %."""

from benchmark import readers


def read(ctx):
    return readers.gemm(ctx) if ctx.train else None
