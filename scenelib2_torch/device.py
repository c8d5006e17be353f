"""Device and precision selection for the port's entry points."""

from __future__ import annotations

import torch

# precision modes: "f32" is the fast mode that the JAX package selects with
# SCENELIB2_X64=0 (state x, P in float32); "f64" is its parity mode
PRECISIONS = {"f32": torch.float32, "f64": torch.float64}


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU. Without one this raises instead of quietly
    running on the CPU: the caller asks for the CPU by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "scenelib2_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)


def resolve_dtype(precision: str) -> torch.dtype:
    try:
        return PRECISIONS[precision]
    except KeyError:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}") from None
