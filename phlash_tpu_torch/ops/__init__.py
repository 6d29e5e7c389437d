"Hand-written CUDA kernels, their plain PyTorch versions, and their build."

from phlash_tpu_torch.ops.packing import dense_transition

__all__ = ["dense_transition"]
