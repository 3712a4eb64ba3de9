"""clair3_tpu_torch — the PyTorch/CUDA port of clair3_tpu.

The port runs the same two-stage calling cascade on an NVIDIA GPU:

  1. pileup network  (BiLSTM over [33, 18] summarized-alignment tensors),
     run as one hand-written CUDA kernel (csrc/pileup_full.cu)
  2. full-alignment network (ResNet over [depth, 33, 8|9] per-read tensors)

Only the nets, the engine that feeds them and the CLI live here.  Feature
extraction, decode, routing, phasing and merge are the numpy/C++ modules of
``clair3_tpu``, imported as they are; this package never imports jax, flax
or optax.
"""

__version__ = "0.1.0"
