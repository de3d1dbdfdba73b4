"""PyTorch + CUDA port of veon_tpu for NVIDIA Hopper.

The JAX package `veon_tpu` is the reference; this package imports nothing
of it. Public functions keep its channel-last layouts. Entry points run on
the card unless the caller passes `device="cpu"`.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: "cuda" by default, which raises
    when no card is present (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device present; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config compute-dtype name -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
