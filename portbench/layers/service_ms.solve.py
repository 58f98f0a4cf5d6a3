"""solver.service's core around a Solve (span, pin, gap-ledger and HBM
scopes): the caller's wall less the solver's encode, dispatch, transfer
and decode, a request's mean."""

PHASES = ("encode_ms", "dispatch_ms", "transfer_ms", "decode_ms")


def read(run):
    return run.mean_counter("solve", lambda r: r["wall_s"] * 1000 - sum(
        r["counters"][k] for k in PHASES))
