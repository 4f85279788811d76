"""PyTorch/CUDA port of the ASCII interchange protocol.

Mirrors ``repro``'s module layout (``repro_torch/core/scores.py`` is the
counterpart of ``repro/core/scores.py``) and holds every part of it against
the JAX package in ``tests/test_torch_*.py``.  It imports ``torch`` only:
never ``jax`` and nothing of ``repro``.
"""
