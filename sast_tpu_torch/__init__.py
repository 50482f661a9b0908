"""PyTorch/CUDA port of the SAST event detector (the JAX package
``sast_tpu`` is the reference). Imports torch, numpy and the standard
library only; the kernels are hand-written CUDA in ``csrc/``."""
