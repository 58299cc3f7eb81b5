"""Device time per step of the GEMM kernels (cuBLAS, CUTLASS), by the
kinds of step_times.py."""

from _common import kind_s


def read(ctx):
    s = kind_s(ctx, ("gemm",))
    return None if not s else 1e3 * s / ctx["items"]
