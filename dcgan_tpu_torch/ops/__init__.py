"""Layers, BatchNorm and the hand-written CUDA kernels with their plain
PyTorch versions."""
