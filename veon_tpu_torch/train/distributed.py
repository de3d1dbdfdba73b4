"""Multi-process bootstrap of data-parallel training (counterpart of
`veon_tpu/train/distributed.py`).

One process drives one card (or one CPU rank over gloo). `initialize`
opens the default `torch.distributed` process group; while one is open,
train-mode BatchNorm and the stage-2 step average over the ranks
(`collectives.py`), so every rank takes the same optimizer step and holds
the same params, EMA and optimizer state without further traffic.

    # two processes on one host, one card each (or --device cpu: gloo)
    python -m veon_tpu_torch.cli.main train ... --dist-coordinator localhost:29500 \\
        --dist-num-processes 2 --dist-process-id {0,1}
    torchrun --nproc-per-node 2 -m veon_tpu_torch.cli.main train ...
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device
from ..collectives import data_parallel


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               backend: Optional[str] = None) -> bool:
    """Open the process group from the arguments or the launcher's
    variables. Returns True if a multi-process group was opened, False for
    the single-process case (world size 1 or no coordinator), which does
    nothing.

    Each value is taken from its argument first; where that is None, from
    torchrun's variables (WORLD_SIZE, RANK), then from the reference's
    dist_train.sh ones as JAX reads them (NNODES, NODE_RANK); the
    coordinator from MASTER_ADDR:MASTER_PORT (port 29500 by default). The
    rank's card is cuda:LOCAL_RANK where torchrun set it, else the process
    id modulo the visible cards, made current before anything is built.
    `backend` defaults to NCCL on the card and gloo with device "cpu".

    JAX's NNODES counts hosts, each process driving all of its host's
    cards; here a process drives one card, so NNODES is taken as the
    number of processes only where that is the same thing: on the CPU, or
    where each host sees one card. With NNODES > 1, no WORLD_SIZE and more
    than one visible card, this raises and names torchrun, rather than
    train on NNODES of the cards."""
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    hosts = None
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", env.get("NNODES", "1")))
        hosts = None if "WORLD_SIZE" in env else num_processes
    if process_id is None:
        process_id = int(env.get("RANK", env.get("NODE_RANK", "0")))
    if num_processes > 1 and coordinator is None:
        raise ValueError(
            f"multi-process world size {num_processes} requested but no "
            "coordinator address: pass --dist-coordinator or set "
            "MASTER_ADDR (otherwise each rank would silently train "
            "independently and clobber the shared work_dir)")
    if coordinator is None or num_processes <= 1:
        return False
    cards = torch.cuda.device_count() if resolve_device(device).type == "cuda" else 1
    if hosts is not None and cards > 1:
        raise ValueError(
            f"NNODES={hosts} counts hosts, and this host sees {cards} cards: the port runs "
            "one process per card, so launch with torchrun --nproc-per-node "
            f"{cards} --nnodes {hosts} (or give --dist-num-processes and "
            "--dist-process-id to each card's process)")
    init_group(coordinator, num_processes, process_id, device, backend)
    return True


def init_group(coordinator: str, world_size: int, rank: int, device="cuda",
               backend: Optional[str] = None) -> None:
    """Make the rank's card current (see `initialize`) and open the default
    process group at tcp://<coordinator>, at any world size."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=f"tcp://{coordinator}", world_size=world_size,
                            rank=rank)


def shutdown() -> None:
    """Close the default process group, where one is open."""
    if data_parallel():
        dist.destroy_process_group()


def process_shard() -> Tuple[int, int]:
    """(rank, count) for the data loader's per-process dataset sharding."""
    return (dist.get_rank(), dist.get_world_size()) if data_parallel() else (0, 1)


def barrier() -> None:
    if data_parallel():
        dist.barrier()


@torch.no_grad()
def broadcast_state(model: torch.nn.Module) -> None:
    """Rank 0's params and buffers (the BatchNorm running stats) onto every
    rank, in place; nothing without a process group."""
    if not data_parallel():
        return
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=0)
