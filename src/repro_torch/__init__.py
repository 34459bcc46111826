"""repro_torch — the ScalLoPS search on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that mirrors it module for module:
``repro_torch/core/simhash.py`` computes what ``repro/core/simhash.py``
computes, bit for bit. The port imports torch and numpy only — never jax,
and nothing of ``repro``.

Entry points take an explicit ``device``; the default is the CUDA card
and raises when there is none. The TPU's Pallas kernels become CUDA C++
kernels for ``sm_90a`` (``kernels/csrc``), each with a plain torch twin
(``kernels/ref.py``) that CPU tensors are routed to.
"""
