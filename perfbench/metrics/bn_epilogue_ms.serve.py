"""bn_epilogue_ms.serve: K8's summed device milliseconds a traced call (the
kernels whose name holds ``bn_epilogue``); None where none ran."""


def read(r):
    ops = r.trace.kernels("bn_epilogue")
    if not ops or not r.trace.calls:
        return None
    return 1e3 * sum(e - s for _, s, e in ops) / r.trace.calls
