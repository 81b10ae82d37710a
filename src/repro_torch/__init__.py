"""PyTorch + CUDA port of the IntSGD system (the JAX package ``repro`` is
the reference it is held against). Paths mirror ``src/repro``; the port
imports ``torch`` and never ``jax`` or ``repro``. Its hand-written Hopper
kernels live in ``csrc`` and are wrapped in :mod:`repro_torch.kernels.ops`.
"""
