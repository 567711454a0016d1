"""CUDA graphs captured inside the window by the engine's programs
(``GraphCache.captures`` of the decode step and the prefill programs):
each is an eager call plus a capture on the timed path."""


def read(w):
    return float(w.graph_captures)
