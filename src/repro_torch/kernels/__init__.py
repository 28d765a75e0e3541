"""Fused macro kernel (CUDA, ``csrc/``), its plain version and wrappers."""
