"""Median host milliseconds of work in one ``step()`` of the window: the
engine's ``step`` span less its ``wait.*`` spans (the host blocked on the
card), from the program's own span recorder
(``repro_torch/serving/trace.py``)."""
import statistics

from lamina_bench import spans


def read(w):
    recorded = getattr(w, "spans", None)
    busy = spans.host_busy_ms(recorded) if recorded else []
    return statistics.median(busy) if busy else None
