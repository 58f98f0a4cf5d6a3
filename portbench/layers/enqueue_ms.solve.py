"""ops.packer's upload and the enqueue of every pack step's kernels in a
Solve: its solver.dispatch.enqueue span, ms a request's mean."""

from portbench.spans import span_ms


def read(run):
    return span_ms(run, "solver.dispatch.enqueue")
