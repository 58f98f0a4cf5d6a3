"""The interpreter's garbage collector inside a Solve's encode: its
runtime.gc spans where they lie inside solver.encode, ms a request's
mean (the part of gc_ms.solve that encode_ms.solve holds)."""

from portbench.spans import overlap_ms


def read(run):
    return overlap_ms(run, "runtime.gc", "solver.encode")
