"""Median host milliseconds of one ``step()`` in the window, from the
benchmark's own span around each call."""
import numpy as np


def read(w):
    if not w.steps:
        return None
    return float(np.median([s.t1 - s.t0 for s in w.steps])) * 1e3
