"""Device memory usage report (reference util.t:907-926 ``reportGPUMemoryUse``).

PyTorch counterpart of ``opt_tpu/utils/memory.py``. The reference queries
cudaMemGetInfo and prints used/free/total; here PyTorch's caching
allocator statistics (``torch.cuda.memory_stats``) give the bytes in use and
their peak, ``torch.cuda.mem_get_info`` the card's total, and
``torch.cuda.memory_allocated`` the live tensors. A CPU device has no such
statistics: :func:`memory_stats` returns None there, as the JAX package's
does for its CPU backend.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
            else torch.device("cpu")
    return torch.device(device)


def memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The caching allocator's statistics on a CUDA device
    (``torch.cuda.memory_stats``), or None on the CPU."""
    device = _device(device)
    if device.type != "cuda":
        return None
    return dict(torch.cuda.memory_stats(device))


def live_buffer_bytes(device=None) -> int:
    """Bytes of live tensors on a CUDA device (``torch.cuda.memory_allocated``);
    0 on the CPU, where the allocator keeps no count."""
    device = _device(device)
    return int(torch.cuda.memory_allocated(device)) if device.type == "cuda" else 0


def report(device=None, print_fn=print) -> str:
    """Human-readable usage line (the reference prints used/free/total MB):
    the bytes of live tensors, their peak and the card's total, then what
    the allocator holds and what the card has free."""
    device = _device(device)
    stats = memory_stats(device)
    if stats:
        used = stats.get("allocated_bytes.all.current", 0) / 1e6
        peak = stats.get("allocated_bytes.all.peak", 0) / 1e6
        reserved = stats.get("reserved_bytes.all.current", 0) / 1e6
        free, total = torch.cuda.mem_get_info(device)
        text = (
            f"{device.type} memory: in use {used:.1f} MB"
            f" (peak {peak:.1f} MB, limit {total / 1e6:.1f} MB);"
            f" reserved by the allocator {reserved:.1f} MB, free on the card {free / 1e6:.1f} MB"
        )
    else:
        text = f"{device.type} memory: live arrays {live_buffer_bytes(device) / 1e6:.1f} MB"
    print_fn(text)
    return text
