"""Tensor ops of the port: the flash-attention kernels and the KV ring."""
