"""Median milliseconds from submit to the engine's ``admit`` event, over
the admissions in the window; the event is stamped when the step that
made it returns."""
import numpy as np


def read(w):
    if not w.admit_waits_s:
        return None
    return float(np.median(w.admit_waits_s)) * 1e3
