"""repro_torch — KERMIT's MAPE-K loop in PyTorch, for one NVIDIA H100.

The port of ``src/repro`` (the JAX reference, which stays as it is).  Each
module ``repro_torch/<pkg>/<mod>.py`` mirrors ``repro/<pkg>/<mod>.py`` and
keeps its public names.  The package imports torch, numpy and the standard
library only.  Entry points run on CUDA unless the caller passes
``device="cpu"``.  The TPU kernels on the ported paths are hand-written
CUDA kernels: ``kernels/csrc/nbr_adjacency.cu`` (DBSCAN discovery) and
``kernels/csrc/flash_attention.cu`` (prefill attention when serving with
``attn_impl="pallas"``).
"""
