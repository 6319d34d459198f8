"""Solver profiling: per-phase timing tables and per-iteration lines.

PyTorch counterpart of ``opt_tpu/utils/timer.py``, the reference's
CUDA-event timer (util.t:404-511): with
``InitializationParameters(collect_per_kernel_timing=True)`` a solve prints
an aggregate table and the greppable ``TIMING`` and ``Per-iter times ms
(nonlinear,linear)`` lines.

The rows are timed on the real solve, never on isolated copies of its
phases: :class:`SolveTimer` records a mark at each phase's entry and exit
(a ``torch.cuda.Event`` on the plan's stream for a plan on the card, the
host clock for one on the CPU), adds no host sync, and is read once, after
the solve's own transfer of its scalar results. A phase that runs inside
another (the ComputedArray bundle inside the field assembly, say) is taken
out of the outer row, so the rows are disjoint; ``other`` is the solve's
time outside every row. The phases take the reference's names where the
work is the same (solverGPUGaussNewton.t) and add the assembly's split:

* ``PCGInit1``: r0 = -JᵀF and the Jacobi diagonal or preconditioner;
* ``PCGStep1``: the CG loop, one fused launch a step (or the eager loop);
  its count is the CG iterations executed, so its average is ms per
  executed iteration;
* ``computeCost``, and under LM ``computeModelCost`` and
  ``PCGComputeCtC`` (the damping and its preconditioner);
* ``computedBundle`` (ComputedArray values and gradients),
  ``assembleConst`` (the loop-invariant products, once a solve),
  ``assembleFields`` (the operator's coefficient fields), ``blockInverse``
  (the block-Jacobi inverses and their packing) and ``explicitJ`` (the
  explicit J's values, ``use_explicit_jtj``);
* on a mesh, each rank's own solve: ``tileApply`` (the sharded loop's
  per-tile apply, K5 on the card), ``haloExchange`` (a halo phase,
  ``Mesh.extend``), ``allReduce`` and ``allToAll`` (the collectives, their
  staging through host memory included). Most of them run inside the CG
  loop, so there ``PCGStep1`` is the loop's own work: its vector updates
  and its dots' local sums.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Dict, Optional

import torch

# the rows in table order; "other" and "overall" follow them
PHASES = ("PCGInit1", "PCGStep1", "computeCost", "PCGComputeCtC", "computeModelCost",
          "computedBundle", "assembleConst", "assembleFields", "blockInverse", "explicitJ",
          "tileApply", "haloExchange", "allReduce", "allToAll")
_ALWAYS = ("PCGInit1", "PCGStep1")  # the TIMING line's rows, shown even when empty

# the timer of the solve running in this context, or None
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("opt_tpu_torch_solve_timer",
                                                         default=None)
_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class PhaseStat:
    count: int = 0
    total_ms: float = 0.0

    @property
    def average_ms(self) -> float:
        return self.total_ms / max(1, self.count)


class Timer:
    """Aggregating wall-clock timer (util.t:404-511 equivalent): each call
    of :meth:`time` ends in a ``torch.cuda.synchronize`` of ``device`` where
    it is a CUDA device, so the time is the call's work on the card."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.stats: Dict[str, PhaseStat] = {}

    def time(self, name: str, fn, *args, repeats: int = 1, **kw):
        out = None
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            ms = (time.perf_counter() - t0) * 1e3
            st = self.stats.setdefault(name, PhaseStat())
            st.count += 1
            st.total_ms += ms
        return out

    def evaluate(self) -> str:
        """Print the aggregate table (util.t:469-476 format)."""
        lines = [
            "--------------------------------------------------------",
            f"{'phase':<28}{'count':>6}{'total(ms)':>12}{'avg(ms)':>10}",
            "--------------------------------------------------------",
        ]
        for name, st in sorted(self.stats.items()):
            lines.append(
                f"{name:<28}{st.count:>6}{st.total_ms:>12.3f}{st.average_ms:>10.3f}"
            )
        lines.append("--------------------------------------------------------")
        text = "\n".join(lines)
        print(text)
        return text


class SolveTimer:
    """The marks of one solve's phases on ``device``'s current stream (CUDA
    events) or the host clock (CPU). Entered around the solve, it is the
    context's active timer, which :func:`phase` and :func:`note_cg` reach;
    :meth:`read` turns the marks into disjoint rows once the solve's
    results are on the host."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._marks = []  # (mark, the row of the span that starts at it, or None)
        self._stack = []
        self.entries: Dict[str, int] = {}
        self.instances: Dict[str, int] = {}  # the CG loop each step ran, and how often
        self._token = None

    def _mark(self):
        if self._cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(self.device))
            return e
        return time.perf_counter()

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        self._marks.append((self._mark(), None))
        return self

    def __exit__(self, *exc):
        self._marks.append((self._mark(), None))
        _ACTIVE.reset(self._token)
        return False

    @contextlib.contextmanager
    def phase(self, name: str, count: bool = True):
        """Time the block as row ``name``; ``count``: one more entry of the
        row (False for a second part of an entry already counted)."""
        self.entries[name] = self.entries.get(name, 0) + int(count)
        self._stack.append(name)
        self._marks.append((self._mark(), name))
        try:
            yield
        finally:
            self._stack.pop()
            self._marks.append((self._mark(), self._stack[-1] if self._stack else None))

    def note_cg(self, ran: Dict[str, int]) -> None:
        for name, n in ran.items():
            self.instances[name] = self.instances.get(name, 0) + n

    def read(self):
        """({row: PhaseStat} in table order, with "other" and "overall"),
        after the timer was left and the device reached its last mark."""
        first, last = self._marks[0][0], self._marks[-1][0]
        if self._cuda:
            last.synchronize()
            t = [0.0] + [float(first.elapsed_time(m)) for m, _o in self._marks[1:]]
        else:
            t = [(m - first) * 1e3 for m, _o in self._marks]
        totals: Dict[str, float] = {}
        for (_m, owner), a, b in zip(self._marks, t, t[1:]):
            if owner is not None:
                totals[owner] = totals.get(owner, 0.0) + (b - a)
        rows = {name: PhaseStat(self.entries.get(name, 0), totals.get(name, 0.0))
                for name in PHASES if name in self.entries or name in _ALWAYS}
        overall = t[-1]
        rows["other"] = PhaseStat(1, overall - sum(s.total_ms for s in rows.values()))
        rows["overall"] = PhaseStat(1, overall)
        return rows


def active() -> Optional[SolveTimer]:
    """The timer of the solve running in this context, or None."""
    return _ACTIVE.get()


def phase(name: str, count: bool = True):
    """:meth:`SolveTimer.phase` of the active timer; a no-op context when no
    timed solve is running."""
    t = _ACTIVE.get()
    return _OFF if t is None else t.phase(name, count)


def note_cg(ran: Dict[str, int]) -> None:
    """Record the CG instances a step ran on the active timer, if any."""
    t = _ACTIVE.get()
    if t is not None:
        t.note_cg(ran)


def _rows(plan):
    phases = getattr(plan, "_timing_phases", None)
    if phases is None:
        raise RuntimeError("no timed solve on this plan: plan it with "
                           "InitializationParameters(collect_per_kernel_timing=True) and solve")
    return phases


def report_solve_timing(plan, result) -> str:
    """Per-solve timing report in the reference Timer:evaluate() format
    (util.t:469-508): the kernel table of the plan's last timed solve (its
    rows on the plan as ``plan._timing_phases``), a line naming the CG
    instances it launched and how often (``plan._timing_instances``), the
    greppable ``TIMING`` line (PCGInit1 / PCGStep1 / overall totals) and
    the ``Per-iter times ms (nonlinear, linear)`` aggregate pair."""
    phases = _rows(plan)
    n = max(1, result.num_iterations)
    lin = max(1, result.num_linear_iterations)
    rows = [(name, st.count, st.total_ms, st.average_ms) for name, st in phases.items()]

    lines = [
        "--------------------------------------------------------",
        "        Kernel        |   Count  |   Total   | Average ",
        "----------------------+----------+-----------+----------",
    ]
    for name, count, total, avg in rows:
        lines.append(
            f" {name:<20} |   {count:4d}   | {total:8.3f}ms| {avg:7.4f}ms"
        )
    lines.append("--------------------------------------------------------")
    ran = getattr(plan, "_timing_instances", None) or {}
    lines.append("CG instances: " + (", ".join(f"{k} x{v}" for k, v in ran.items()) or "none"))
    timing_vals = [
        f"{total:f}"
        for name, _c, total, _a in rows
        if name.startswith(("PCGInit1", "PCGStep1", "overall"))
    ]
    lines.append("TIMING " + " ".join(timing_vals) + " ")
    # NOTE: despite the label, the reference prints AGGREGATE totals here —
    # util.t:487-508 sums the total duration of every kernel whose launch
    # count matches the nonlinear / linear iteration count. Matched verbatim
    # so greppers calibrated on reference logs read like-for-like numbers;
    # per-iteration marginals live in profile_plan's "Marginal times" line.
    kernels = rows[:-2]  # "other" and "overall" are not kernels
    nl_total = sum(t for _n, c, t, _a in kernels if c == n)
    lin_total = sum(t for _n, c, t, _a in kernels if c == lin)
    if n == lin:  # counts coincide: everything lands in both buckets
        lin_total = nl_total
    lines.append(
        f"Per-iter times ms (nonlinear,linear): {nl_total:7.4f}\t{lin_total:7.4f}"
    )
    text = "\n".join(lines)
    print(text)
    return text


def profile_plan(plan, inputs, n_nonlinear: int = 3, l_small: int = 10, l_big: int = 50):
    """Time one solve of ``n_nonlinear`` steps of up to ``l_big`` CG
    iterations with the phase timer on, whatever the plan's
    ``collect_per_kernel_timing``; prints the phase table, the ``TIMING``
    line and the per-iteration line. Returns {"phases": {row: average ms},
    "nonlinear_ms": the solve's time a nonlinear step, "linear_ms":
    PCGStep1's time a CG iteration executed}. Both come from the one timed
    solve, not from the difference of two solves (which jitter can make
    negative), so ``l_small`` is accepted for the reference's signature and
    not used."""
    del l_small
    res = plan._solve(dict(inputs), False, True,
                      {"nIterations": n_nonlinear, "lIterations": l_big})
    phases = _rows(plan)
    timer = Timer(plan.device)
    timer.stats = {k: v for k, v in phases.items() if k != "overall"}
    timer.evaluate()
    # machine-greppable lines; the TIMING format follows util.t:477-508 but
    # the marginal line deliberately does NOT reuse the reference's
    # "Per-iter times" label: that label prints aggregate totals in the
    # reference (see report_solve_timing), while these are per iteration
    total_ms = sum(s.total_ms for s in timer.stats.values())
    nonlinear_ms = phases["overall"].total_ms / max(1, res.num_iterations)
    linear_ms = phases["PCGStep1"].total_ms / max(1, res.num_linear_iterations)
    print(f"TIMING {total_ms:.3f}ms")
    print(f"Marginal times ms (nonlinear,linear): ({nonlinear_ms:.4f}, {linear_ms:.4f})")
    return {
        "phases": {k: v.average_ms for k, v in timer.stats.items()},
        "nonlinear_ms": nonlinear_ms,
        "linear_ms": linear_ms,
    }
