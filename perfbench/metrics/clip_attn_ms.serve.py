"""clip_attn_ms.serve: K11's summed device milliseconds a traced call (the
kernels whose name holds ``clip_attn``: the attention of CLIP's blocks,
GALIP's text transformer and bridge); None where none ran (another
family, or a port without K11)."""


def read(r):
    ops = r.trace.kernels("clip_attn")
    if not ops or not r.trace.calls:
        return None
    return 1e3 * sum(e - s for _, s, e in ops) / r.trace.calls
