"""Process start to the first timed request: import, the CUDA context, the
kernels from the checkout's build cache, the catalog, Sync, warm-up."""


def read(run):
    return run.setup_s
