"""The host's time to hand a frame to ``render_arrays`` until the call
returns, before any synchronisation (the enqueue cost), mean over the
untraced frames of the traced run, ms."""

KERNELS = ()


def read(rec):
    if not rec.host_s:
        return None
    return 1000.0 * sum(rec.host_s) / len(rec.host_s)
