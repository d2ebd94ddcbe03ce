"""The host's time from calling the training step until it returns,
before any synchronisation (the enqueue cost, and any wait for a full
launch queue), mean over the untraced steps of the traced run, ms."""

KERNELS = ()


def read(rec):
    if not rec.host_s:
        return None
    return 1000.0 * sum(rec.host_s) / len(rec.host_s)
