"""Block-sparse kernels: plain PyTorch executors (``ref``), planning
metadata and the CUDA kernel wrappers (``tensordash_spmm``), the block
zero-mask (``block_mask``), the stream scheduler (``schedule``) and the
public wrappers on the resolved runtime (``ops``)."""
from repro_torch.kernels.block_mask import block_zero_mask

__all__ = ["block_zero_mask"]
