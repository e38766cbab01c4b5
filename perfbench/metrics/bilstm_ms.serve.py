"""bilstm_ms.serve: K9's summed device milliseconds a traced call (the
kernels whose name holds ``bilstm``: the text encoder's recurrence); None
where none ran (cuDNN's packed RNN, before K9)."""


def read(r):
    ops = r.trace.kernels("bilstm")
    if not ops or not r.trace.calls:
        return None
    return 1e3 * sum(e - s for _, s, e in ops) / r.trace.calls
