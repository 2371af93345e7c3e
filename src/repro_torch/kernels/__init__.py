"""Block-sparse kernels: plain PyTorch executors (``ref``), planning
metadata and the CUDA kernel wrappers (``tensordash_spmm``)."""
