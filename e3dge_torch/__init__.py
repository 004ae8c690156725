"""PyTorch/CUDA port of E3DGE (the JAX package `e3dge_tpu` is its reference).

Importing the package builds nothing and imports no Triton: the field kernel
(`csrc/siren_field.cu`) is compiled with nvcc at its first launch on a card.
"""
