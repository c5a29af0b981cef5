"""Model ops (patch embed, attention, MLP) and the CUDA kernels (ops.cuda)."""

from peekvit_torch.ops.attention import (
    SelfAttention,
    get_attention_impl,
    multi_head_attention,
    set_attention_impl,
)

__all__ = ["SelfAttention", "get_attention_impl", "multi_head_attention", "set_attention_impl"]
