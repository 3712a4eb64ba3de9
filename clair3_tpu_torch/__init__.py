"""clair3_tpu_torch — the PyTorch/CUDA port of clair3_tpu.

The port runs the same two-stage calling cascade on an NVIDIA GPU:

  1. pileup network  (BiLSTM over [33, 18] summarized-alignment tensors),
     run as one hand-written CUDA kernel (csrc/pileup_full.cu)
  2. full-alignment network (ResNet over [depth, 33, 8|9] per-read tensors)

The nets, the engine that feeds them, the kernels and the CLI are the
port's own.  Feature extraction, decode, routing, phasing, merge, the I/O
codecs and the native (C++) host library are copies of the framework-free
modules of ``clair3_tpu`` under the same relative paths, held equal to
their originals by ``tests/test_torch_copies.py``.  This package imports
nothing of ``clair3_tpu``, and never jax, flax or optax: it runs where
neither is installed.
"""

__version__ = "0.1.0"
