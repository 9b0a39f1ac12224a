"""PyTorch/CUDA port of trafficbotsv15_tpu for one NVIDIA H100.

Mirrors the JAX package's layout and module names. It imports torch and numpy,
never jax, flax or trafficbotsv15_tpu. Entry points run on the CUDA device
unless the caller passes device="cpu".
"""
