"""The least time an H100 takes to read a tensor that sits in its L2.

    from scripts.l2_read_floor import l2_read_ms   # chip_smoke.py loads it by path

``l2_read_ms(x, reps)`` times one Triton launch that reads the float32
tensor ``x`` ``reps`` times and does nothing else, and returns ms a read.
The tensor is cut into as many contiguous chunks as the launch has
programs (two an SM); at repeat r program p reads chunk (p + 67·r) mod P,
so no program reads one chunk twice and no address repeats within a
program, and every load bypasses L1 (``.cg``): the reads come from L2
whenever ``x`` fits there (the 50 MB L2 of an H100; arap36k's fields are
26.7 MB). The programs' sums are held to ``reps`` times the tensor's sum,
so the reads cannot have been dropped. It is a floor for a kernel that
reads the same bytes from L2 every iteration, such as the graph kernel's
stream layout, which reads a graph's fields once an iteration. Triton is
imported with this module, so import it only on a machine with the card.
"""

import torch
import triton
import triton.language as tl

BLOCK = 8192  # floats a program loads a step: 32 a thread at 8 warps
STRIDE = 67  # a repeat moves each program this many chunks on


@triton.jit
def _read(x, out, n, P, R, CHUNK, BLOCK: tl.constexpr, STRIDE: tl.constexpr):
    p = tl.program_id(0)
    offs = tl.arange(0, BLOCK)
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for r in range(R):
        lo = ((p + STRIDE * r) % P) * CHUNK
        for i in range(0, CHUNK, BLOCK):
            idx = lo + i + offs
            acc += tl.load(x + idx, mask=(i + offs < CHUNK) & (idx < n), other=0.0,
                           cache_modifier=".cg")
    tl.store(out + p, tl.sum(acc, axis=0))


def l2_read_ms(x, reps=100, launches=5):
    """ms to read the contiguous float32 CUDA tensor ``x`` once: the mean
    over ``launches`` launches (after a warm-up) of one launch of ``reps``
    reads, CUDA events, divided by ``reps``. Raises if the programs' sums
    are not ``reps`` times the tensor's (within 1e-4 of ``reps`` times the
    sum of its magnitudes)."""
    flat = x.reshape(-1)
    if flat.dtype != torch.float32 or not flat.is_cuda:
        raise ValueError(f"l2_read_ms takes a float32 CUDA tensor, got {flat.dtype} on "
                         f"{flat.device}")
    n = flat.numel()
    P = 2 * torch.cuda.get_device_properties(flat.device).multi_processor_count
    if P % STRIDE == 0:  # then a program would come back to its chunk
        P += 1
    chunk = -(-n // P)
    chunk = -(-chunk // 64) * 64  # each chunk starts 256 B aligned
    out = torch.empty(P, dtype=torch.float32, device=flat.device)

    def launch():
        _read[(P,)](flat, out, n, P, reps, chunk, BLOCK=BLOCK, STRIDE=STRIDE, num_warps=8)

    launch()
    torch.cuda.synchronize()
    want = reps * float(flat.double().sum())
    got = float(out.double().sum())
    if abs(got - want) > 1e-4 * reps * float(flat.double().abs().sum()):
        raise RuntimeError(f"l2_read_ms: the reads summed to {got}, expected {want}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches / reps
