"""The 95th percentile of every inter-token gap whose later token falls
in the window, over all requests (the gap from a handed-over first token
to the next one included), in milliseconds."""
import numpy as np


def read(w):
    return float(np.percentile(w.gaps_s, 95)) * 1e3 if w.gaps_s else None
