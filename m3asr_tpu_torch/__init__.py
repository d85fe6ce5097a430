"""PyTorch/CUDA port of m3asr_tpu for NVIDIA Hopper (H100).

Imports torch and numpy, never JAX and nothing of m3asr_tpu.
"""
