"""Share of the window, in percent, in which no operation ran on the
device: 1 - the device's busy seconds a step in the traced slice (the
union of the trace's device intervals over the slice's steps) times the
window's steps, over the window's host seconds. The profiler slows the
host's side of a step, not the card's, so the slice's own idle share
overstates the window's; the busy time a step carries over."""


def read(w):
    t = w.traced
    if t is None or not t.steps or w.window_s <= 0:
        return None
    busy = t.profile["busy_s"] / len(t.steps) * len(w.steps)
    return 100.0 * (1.0 - busy / w.window_s)
