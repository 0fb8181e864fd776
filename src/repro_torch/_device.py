"""The port's one device rule: every public function runs on the card unless
its caller names the CPU.  There is no fallback to the host."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device (None means the card); a CUDA device must
    be visible.  ``"meta"`` passes too: it holds shapes only (the dry-run's
    decode states), so it cannot stand in for the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is visible; pass device='cpu' "
            "to run the plain versions on the host"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
