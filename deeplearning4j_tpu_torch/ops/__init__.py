"""Tensor ops of the port: the flash-attention kernels, the KV ring and
the updater's fused Adam kernel."""
