"""ops.packer's host side of a Solve: padding and resource compression,
upload and the enqueue of the pack (dispatch_ms), a request's mean."""


def read(run):
    return run.mean_counter("solve", lambda r: r["counters"]["dispatch_ms"])
