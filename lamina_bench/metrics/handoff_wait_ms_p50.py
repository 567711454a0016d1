"""Median milliseconds from a payload's enqueue to its last block issued,
over the handoffs completed in the window (``EngineStats.
handoff_latencies``: a queue wait, not a copy time; nothing synchronises)."""
import numpy as np


def read(w):
    if not w.handoff_waits_s:
        return None
    return float(np.median(w.handoff_waits_s)) * 1e3
