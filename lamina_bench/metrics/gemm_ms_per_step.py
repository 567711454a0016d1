"""Device milliseconds a step of the cuBLAS / CUTLASS matmul kernels (by
name, the traced slice's sum over its steps)."""


def read(w):
    t = w.traced
    if t is None or not t.steps:
        return None
    return t.profile["gemm_s"] * 1e3 / len(t.steps)
