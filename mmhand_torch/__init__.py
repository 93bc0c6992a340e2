"""PyTorch/CUDA port of mmhand_tpu, for NVIDIA Hopper GPUs.

It mirrors mmhand_tpu's module paths and names and imports no JAX.  Each
Pallas kernel of mmhand_tpu on a ported path is a hand-written CUDA kernel
here (``csrc/``), built with nvcc at first use, beside a plain PyTorch
version that the CPU path runs.
"""
