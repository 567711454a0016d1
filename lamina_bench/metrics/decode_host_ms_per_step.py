"""Mean host milliseconds of the decode iteration over the window's steps
that decoded: the ``step.decode`` span less the ``wait.*`` spans inside
it (batch, pool pressure, operands, the graph's replay call, the pool
write, sampling and the stats lines)."""
from lamina_bench import spans


def read(w):
    recorded = getattr(w, "spans", None)
    ms = [s["decode_ns"] / 1e6 for s in spans.step_splits(recorded or [])
          if s["decode_ns"] is not None]
    return sum(ms) / len(ms) if ms else None
