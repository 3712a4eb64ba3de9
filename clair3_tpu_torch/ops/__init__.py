"""Plain tensor functions and the wrappers of the hand-written CUDA kernels."""
