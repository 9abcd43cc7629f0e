"""repro_torch — KERMIT's MAPE-K loop in PyTorch, for one NVIDIA H100.

The port of ``src/repro`` (the JAX reference, which stays as it is).  Each
module ``repro_torch/<pkg>/<mod>.py`` mirrors ``repro/<pkg>/<mod>.py`` and
keeps its public names.  The package imports torch, numpy and the standard
library only.  Entry points run on CUDA unless the caller passes
``device="cpu"``; the TPU kernel on the main path is the hand-written CUDA
kernel ``kernels/csrc/nbr_adjacency.cu``.
"""
