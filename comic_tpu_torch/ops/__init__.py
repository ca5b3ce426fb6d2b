"""Hand-written CUDA kernels (sm_90a) and their plain PyTorch versions."""
