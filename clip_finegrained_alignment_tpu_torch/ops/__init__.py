from .attention import flash_attention
from .flash_attention import BLOCKWISE_THRESHOLD, blockwise_flash_attention
from .sparc_kernel import fused_sparc_pooling

__all__ = ["flash_attention", "blockwise_flash_attention",
           "BLOCKWISE_THRESHOLD", "fused_sparc_pooling"]
