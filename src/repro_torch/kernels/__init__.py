"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``,
built with nvcc at first use and bound with ctypes), each beside its
plain PyTorch version."""
