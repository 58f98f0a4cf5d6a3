"""ops.open_claim's hand-written fill (csrc/open_claim.cu, both launches):
device ms a Solve, from the trace. Silent where the fill did not run."""

KERNELS = ("open_claim_qmax_kernel", "open_claim_apply_kernel")


def read(run):
    return run.device_ms_per_request("solve", KERNELS)
