"""Seconds from the process's start to the window's opening: imports,
weights, templates, the engine, the kernels' build where one is due, the
fill and the warm-up with its graph captures."""


def read(w):
    return w.setup_s
