"""Layers and sub-networks of the IST-Net eval forward (PyTorch)."""
