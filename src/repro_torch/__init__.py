"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The layout mirrors ``src/repro/`` module for module, so every port module
sits at the same relative path as the JAX module it translates. The JAX
package is the reference: ``tests/test_torch_*.py`` feed both packages the
same seeded inputs and compare. This package imports ``torch`` and numpy
only, never ``jax`` and never ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve``); on the CPU every kernel wrapper takes its
plain PyTorch version, on a CUDA tensor it launches the hand-written kernel
(``repro_torch/csrc``) or raises.
"""
