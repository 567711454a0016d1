"""Median milliseconds from a request's arrival to the engine's ``admit``
event, stamped by the engine when it fires (``EngineEvent.t_s``), over
the admissions in the window."""
import statistics


def read(w):
    waits = getattr(w, "queue_waits_s", None)
    return statistics.median(waits) * 1e3 if waits else None
