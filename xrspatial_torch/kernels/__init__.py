"""Stencil twins (torch) and their hand-written CUDA kernels."""
