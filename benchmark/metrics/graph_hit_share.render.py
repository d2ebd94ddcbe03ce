"""The share of the traced frames that the port's captured frame graph
served (``frame_graph.FrameGraphs``): replays over replays plus eager
frames, from the change in ``render_arrays``'s counters over the traced
frames, %."""

KERNELS = ()


def read(rec):
    replays = rec.counters.get("render.render_arrays.replays")
    eager = rec.counters.get("render.render_arrays.eager")
    if replays is None or eager is None or replays + eager <= 0:
        return None
    return 100.0 * replays / (replays + eager)
