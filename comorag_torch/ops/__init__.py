"""Tensor ops of the port: plain PyTorch functions and the wrappers of the
hand-written Hopper kernels (``csrc/``)."""
