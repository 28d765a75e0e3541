"""Device selection shared by the port's entry points.

Entry points default to the GPU.  The CPU is used only when the caller
asks for it (``device="cpu"``, as the CPU tests do); without a GPU and
without that request an entry point raises instead of carrying on on the
CPU.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` means ``cuda``.  A CUDA device on a machine without one
    raises ``RuntimeError``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
