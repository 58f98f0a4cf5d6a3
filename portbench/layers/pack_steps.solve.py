"""ops.packer's pack steps a Solve: the solver's `steps` counter (one step a
pod group up to the last that holds pods), a request's mean. Each step
enqueues its own kernels, the open-claim fill's two launches among them."""


def read(run):
    return run.mean_counter("solve", lambda r: r["counters"]["steps"])
