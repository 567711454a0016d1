"""Share, in percent, of the traced slice's device-idle time (its merged
gaps of 20 us or more) during which no engine ``step`` span is open: the
benchmark's own loop between two steps."""


def read(w):
    t = w.traced
    sp = getattr(t, "span_profile", None) if t is not None else None
    if not sp or sp["idle_s"] <= 0:
        return None
    return 100.0 * sp["idle_outside_step_s"] / sp["idle_s"]
