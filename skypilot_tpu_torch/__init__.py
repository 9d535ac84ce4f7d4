"""PyTorch/CUDA port of sky-tpu's compute plane.

A second package beside ``skypilot_tpu``, with the same layout
(``ops/``, ``models/``, ``infer/``) so each module's counterpart is easy
to find. It imports ``torch`` and never ``jax`` nor anything of
``skypilot_tpu``: the JAX package stays the reference the port is held
to by the ``tests/test_torch_*.py`` differential tests.

The Pallas TPU kernels on the ported path are hand-written CUDA C++
kernels for Hopper (``ops/csrc/``), built with ``nvcc`` for ``sm_90a`` at
first use (``ops/_build.py``).
"""
