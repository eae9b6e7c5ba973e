"""PyTorch/CUDA port of IterMVS for NVIDIA Hopper.

Mirrors the JAX package `itermvs_tpu/` module for module and is tested
against it. It imports neither JAX nor anything of the JAX package.
"""
