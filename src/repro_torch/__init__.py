"""PyTorch/CUDA port of the ``repro`` serving stack (reference: ``src/repro``).

The package mirrors ``repro`` module for module: ``repro_torch.X.Y`` is the
counterpart of ``repro.X.Y`` and names it in its docstring. It imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro`` — so it
runs on a GPU image without JAX.

Every paged-attention kernel on the serving path is a hand-written CUDA
kernel for Hopper (``csrc/*.cu``, built with ``nvcc`` at first use). Each
kernel has a plain PyTorch twin of the same signature in the same module;
the wrapper runs the twin only for tensors that lie on the CPU (the tests)
and launches the kernel, or raises, for CUDA tensors. Entry points take a
``device`` that defaults to ``"cuda"``: on a machine without a GPU a call
that does not pass ``device="cpu"`` raises instead of falling back.
"""
