"""The R-GCN conv and its CUDA span kernels."""
