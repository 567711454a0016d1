"""The 90th percentile, in milliseconds, of submit to first token over
every request whose first token falls in the window (submitted requests
only: a handed-over request's first token came with it)."""
import numpy as np


def read(w):
    return float(np.percentile(w.ttfts_s, 90)) * 1e3 if w.ttfts_s else None
