"""ops.packer's build_pack_inputs in a Solve (padding to the bucket, the
resource compression): its solver.dispatch.inputs span, ms a request's
mean."""

from portbench.spans import span_ms


def read(run):
    return span_ms(run, "solver.dispatch.inputs")
