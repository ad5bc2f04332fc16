"""The R-GCN conv, its CUDA kernels and their plain PyTorch versions."""
