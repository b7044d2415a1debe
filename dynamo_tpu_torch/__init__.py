"""dynamo_tpu_torch: the PyTorch/CUDA port of dynamo_tpu for NVIDIA Hopper.

The package imports torch, numpy and the standard library only. Its CUDA
kernels (dynamo_tpu_torch/csrc) are built with nvcc at first use, never at
import, so every module imports on a machine with no GPU and no toolkit.
Every entry point runs on `cuda` unless the caller asks for `cpu`.
"""
