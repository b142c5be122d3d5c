"""Device resolution: the CUDA device, or the CPU only when a caller names it."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The torch.device the port's tensors live on.

    None (the default everywhere) and "cuda" resolve to the CUDA device and
    raise when CUDA is absent: nothing moves to the CPU on its own. The CPU
    is used only when the caller passes ``device="cpu"``, as the tests do;
    there every kernel wrapper runs its plain PyTorch version.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
