"""The plain reference that decides whether a benchmark run is correct.

A frozen copy of the PyTorch port's serving model, lift and text-merge
code, as it stood when the benchmark was written, with the plain fp32
`index_add_` pools (`ops/bev_pool.py`) in place of the hand-written
kernels #1-#3. It imports nothing of the port, of the JAX package or of
JAX, and takes nothing the port made: the benchmark makes the weights
and frames from the seed and hands the same to both sides, and
this package works out the rig's presort, the classifier's merge and the
temporal cache again by itself. Run it in fp32 with TF32 off
(`no_tf32`).
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device the reference runs on; "cuda" raises without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device present")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config compute-dtype name -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def no_tf32() -> None:
    """fp32 stays fp32 on the card: no TF32 in convolutions or matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
