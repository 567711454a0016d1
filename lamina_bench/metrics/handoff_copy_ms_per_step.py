"""Device milliseconds a step of the handoff's copies and kernels
(``kvcache.write_handoff_blocks``): the device time of the work that CUDA
calls inside ``handoff.transfer`` spans launched (matched by correlation
id), over the traced slice's steps."""


def read(w):
    t = w.traced
    sp = getattr(t, "span_profile", None) if t is not None else None
    if not sp or not sp["handoff_spans"] or not t.steps:
        return None
    return sp["handoff_copy_s"] * 1e3 / len(t.steps)
