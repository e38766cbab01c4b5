"""memread_ms.serve: the memory form's summed device milliseconds a traced
call (the kernels whose name holds ``memread``: DM-GAN's memory read and
response gate); None where none ran (another family, or a port without
the memory form)."""


def read(r):
    ops = r.trace.kernels("memread")
    if not ops or not r.trace.calls:
        return None
    return 1e3 * sum(e - s for _, s, e in ops) / r.trace.calls
