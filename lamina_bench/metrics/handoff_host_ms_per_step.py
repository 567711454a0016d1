"""Mean host milliseconds a step of the window in a decode engine's
handoff queues (the ``step.handoff`` span: resets, preallocation, the
transfers' calls, admission into the batch)."""
from lamina_bench import spans


def read(w):
    recorded = getattr(w, "spans", None)
    steps = spans.step_splits(recorded or [])
    if not any("step.handoff" in s["by_name"] for s in steps):
        return None
    return sum(s["by_name"]["step.handoff"] for s in steps) / \
        len(steps) / 1e6
