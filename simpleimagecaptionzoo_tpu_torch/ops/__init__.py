"""Decode engine and the wrappers of the hand-written CUDA kernels."""
