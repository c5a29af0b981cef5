"""Hand-written CUDA kernels of the encoder layer, their wrappers and
plain versions (fused_attention) and the nvcc loader (_build)."""
