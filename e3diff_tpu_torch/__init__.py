"""PyTorch / CUDA port of e3diff_tpu for one NVIDIA H100.

The JAX package ``e3diff_tpu`` is the reference; this package imports
neither it nor JAX. Module names mirror the JAX package. Entry points run
on the card (``device="cuda"``) unless the caller asks for the CPU.
"""
