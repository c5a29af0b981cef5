"""Model ops (patch embed, attention, MLP) and the CUDA kernels (ops.cuda)."""
