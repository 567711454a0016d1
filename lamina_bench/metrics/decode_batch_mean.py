"""Mean decode batch of the window's steps (``EngineStats.batch_sizes``)."""
import numpy as np


def read(w):
    return float(np.mean(w.batch_sizes)) if w.batch_sizes else None
