"""Row 1 (``kernels/paged_decode_attention.py``, kernel
``paged_decode_kernel``) against its roofline, in percent: the least time
the card needs for the window's decode steps (each step's live K/V read
once, q in, the fp32 partial out, tables; or its FLOPs, whichever bounds)
over the kernel's device time in the traced slice."""
from lamina_bench import counts
from lamina_bench.profile import kernel_seconds


def read(w):
    tr = w.traced
    if tr is None:
        return None
    t = kernel_seconds(tr.profile, "paged_decode_kernel")
    if t <= 0:
        return None
    bound = sum(counts.roofline_seconds(
        counts.paged_decode_flops(w.dims, s.ctx_sum),
        counts.paged_decode_bytes(w.dims, s.decoded, s.ctx_sum, s.blocks))
        for s in tr.steps if s.decoded)
    return 100.0 * bound / t
