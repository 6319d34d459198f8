"""Process-group bootstrap: the counterpart of ``opt_tpu/parallel/distributed.py``.

The JAX package starts several hosts with ``jax.distributed.initialize``;
here every rank is a process of one ``torch.distributed`` group, and the
caller names the rendezvous, the world and the rank (nothing on a card's
machine tells a program of a cluster). The backend is the caller's choice:

* ``"nccl"`` when every rank has a card of its own;
* ``"gloo"`` for ranks on the CPU, and for several ranks that share one
  card (their halos and dots then pass through host memory).

NCCL refuses two ranks on one device, so asking for it with more ranks on
this host than cards raises instead of switching backends.

Typical use, one process a rank::

    from opt_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize("tcp://localhost:29511", world_size=4, rank=r,
                           backend="nccl")
    mesh = make_mesh()                      # most-square, here 2 x 2
    plan = problem.plan(dims=..., mesh=mesh)
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Idempotent ``torch.distributed.init_process_group``; returns True when
    running multi-process after the call. With no ``init_method`` and no
    ``world_size`` the process stays alone (a world of one, False).
    ``backend`` must be given for a world of several: "nccl" (one card a
    rank) or "gloo" (CPU ranks, or ranks that share a card)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and world_size is None:
        return False
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    world_size = int(world_size)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local > cards:
            raise ValueError(
                f"backend 'nccl' needs one card a rank: {local} ranks on this host, "
                f"{cards} card(s) visible, so two ranks would share one device, which "
                "NCCL refuses; use backend='gloo' for ranks that share a card"
            )
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=int(rank))
    return world_size > 1


def is_primary() -> bool:
    """True on rank 0, or when no process group is running."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
