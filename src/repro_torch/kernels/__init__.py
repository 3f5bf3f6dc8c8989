"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions (``ref``) and the wrappers that choose between them by device."""
