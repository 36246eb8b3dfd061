"""PyTorch/CUDA port of pulse_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module paths; imports torch and never JAX or the
JAX package. Entry points run on CUDA unless given device="cpu", where the
hand-written kernels' plain PyTorch versions run instead.
"""
