"""Device ms a unit in the elementwise and copy / cast kernels: the memory
passes around the GEMMs."""

from portbench import readers, yardstick


def read(ctx):
    return readers.kind_ms(ctx, yardstick.MEMORY_PASS_KINDS)
