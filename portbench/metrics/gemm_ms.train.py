"""Device ms a unit in GEMM kernels (the frozen kind table)."""

from portbench import readers


def read(ctx):
    return readers.kind_ms(ctx, ("GEMM",))
