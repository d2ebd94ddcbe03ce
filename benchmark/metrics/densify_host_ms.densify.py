"""The host's time in the adaptive step's own stages, the ``gs.grad_stats``
and ``gs.densify`` spans, a traced step (a mean over the ``gs.step``
roots), ms; none where a traced window holds no event."""

KERNELS = ()


def read(rec):
    stages = rec.spans.get("stages", {})
    roots = rec.spans.get("roots", 0)
    if "gs.grad_stats" not in stages or "gs.densify" not in stages or roots <= 0:
        return None
    host = stages["gs.grad_stats"]["host_s"] + stages["gs.densify"]["host_s"]
    return 1000.0 * host / roots
