"""Device kernels a Solve launches (copies and sets left out): the host's
enqueue work that a step graph or a fused kernel would shrink."""


def read(run):
    if run.kind != "solve" or not run.device or not run.requests:
        return None
    return len(run.kernels()) / len(run.requests)
