"""Row 2 (``kernels/paged_prefill_attention.py``, kernel
``paged_prefill_chunk_kernel``) against its roofline, in percent: the
least time the card needs for the window's chunks (causal operations of
their real rows, or their bytes, whichever bounds) over the kernel's
device time in the traced slice."""
from lamina_bench import counts
from lamina_bench.profile import kernel_seconds


def read(w):
    tr = w.traced
    if tr is None:
        return None
    t = kernel_seconds(tr.profile, "paged_prefill_chunk_kernel")
    chunks = [c for s in tr.steps for c in s.chunks]
    if t <= 0 or not chunks:
        return None
    bound = sum(counts.roofline_seconds(
        counts.paged_prefill_flops(w.dims, start, n),
        counts.paged_prefill_bytes(w.dims, start, n)) for start, n in chunks)
    return 100.0 * bound / t
