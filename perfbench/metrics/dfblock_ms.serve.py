"""dfblock_ms.serve: K7's summed device milliseconds a traced call (the
kernels whose name holds ``dfblock``); None where none ran."""


def read(r):
    ops = r.trace.kernels("dfblock")
    if not ops or not r.trace.calls:
        return None
    return 1e3 * sum(e - s for _, s, e in ops) / r.trace.calls
