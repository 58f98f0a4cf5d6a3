"""The card's idle share over the Solves' windows: 1 less the union of its
kernels and copies over the time the caller waited, in percent."""


def read(run):
    return run.idle_share("solve")
