"""GNOT in PyTorch and CUDA for NVIDIA Hopper (H100).

A port of the JAX package ``gnot_tpu`` that keeps its module layout
(``config``, ``data/``, ``ops/``, ``models/``, ``serve/``, ``main``)
so every module here has a counterpart there. Plain tensor work is
PyTorch; every kernel the JAX package wrote in Pallas for the TPU is a
kernel written by hand for ``sm_90a`` under ``csrc/``, with a plain
PyTorch version beside it that the CPU tests and the on-card check use.

This package imports ``torch`` and numpy only, never JAX, flax or
``gnot_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
