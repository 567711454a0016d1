"""The plain reference of the benchmark's configurations: plain PyTorch,
float32 with TF32 off, no kernels, no cache, no batching. It imports
nothing of ``repro_torch``, ``repro`` or ``jax``."""
