"""The port's example harness (opt_tpu_torch/harness.py) held to the JAX
package's (opt_tpu/harness.py, tests/test_harness.py) on a 12x12 laplacian:
the same runs give the same final costs, the same '**Final Costs**' block,
CSV header and graph-file layout, numbers aside; the hooks, the scipy run,
the device schedule and a pyramid's re-planning hook work as there."""

import os

import numpy as np
import pytest
import torch

import opt_tpu.harness as jh
import opt_tpu_torch.harness as th
from opt_tpu.models.specs import laplacian as jlaplacian
from opt_tpu_torch.models.specs import laplacian as tlaplacian

torch.set_num_threads(2)

N = 12
PARAMS = {"numIter": 2, "nonLinearIter": 3, "linearIter": 20}


def lap_inputs(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return {"X": rng.rand(n, n).astype(np.float32), "A": rng.rand(n, n).astype(np.float32)}


def solver_class(base, spec, device=None):
    """A laplacian app on either package's harness: the target image moves
    towards a shifted copy across the outer solves (the annealing of the
    image_warping app), the unknowns reset for each solver."""

    class Lap(base):
        collect_timing = False

        def combined_solve_init(self):
            self.start = lap_inputs()
            self.problem_inputs = dict(self.start)

        def pre_single_solve(self):
            self.problem_inputs["X"] = self.start["X"].copy()

        def pre_nonlinear_solve(self, i):
            a = (i + 1) / self.solver_params["numIter"]
            self.problem_inputs["A"] = ((1 - a) * self.start["A"]
                                        + a * np.roll(self.start["A"], 1, 0)).astype(np.float32)

    if device is not None:
        Lap.device = device
    return Lap(spec, {"W": N, "H": N}, dict(PARAMS))


def run(solver):
    solver.add_opt_solvers()
    solver.add_scipy_reference_solver(max_nfev=5)
    solver.solve_all()
    return solver


def without_numbers(text):
    return [ln.split(":")[0] for ln in text.splitlines()]


@pytest.fixture(scope="module")
def both():
    return run(solver_class(th.CombinedSolverBase, tlaplacian, "cpu")), run(
        solver_class(jh.CombinedSolverBase, jlaplacian))


def test_solve_all_matches_the_jax_harness(both, capsys):
    """GN, LM and the scipy run: each outer solve's cost at 1e-6 of the JAX
    harness's, and the Final Costs block line for line."""
    port, jax_ = both
    assert [r.name for r in port.runs] == [r.name for r in jax_.runs] == [
        "Opt(GN)", "Opt(LM)", "CERES-analogue(scipy)"]
    for r, jr in zip(port.runs, jax_.runs):
        assert len(r.iterations) == len(jr.iterations)
        np.testing.assert_allclose([i.cost for i in r.iterations],
                                   [i.cost for i in jr.iterations], rtol=1e-6)
        assert all(i.duration_ms > 0 for i in r.iterations)
    text, jtext = port.report_final_costs(), jax_.report_final_costs()
    assert text.splitlines()[0] == "**Final Costs**"
    assert without_numbers(text) == without_numbers(jtext)
    assert capsys.readouterr().out.count("**Final Costs**") == 2
    assert port.plan.device.type == "cpu"


def test_results_csv_and_graphs_match_the_jax_layout(both, tmp_path):
    """save_results_csv (with its legacy mirror) and
    save_convergence_graphs: the same files, header and row layout."""
    port, jax_ = both
    files = {}
    for label, s in (("port", port), ("jax", jax_)):
        d = str(tmp_path / label)
        csv = s.save_results_csv(d)
        graphs = s.save_convergence_graphs(d)
        files[label] = (d, csv, graphs)
    (d, csv, graphs), (jd, jcsv, jgraphs) = files["port"], files["jax"]
    assert sorted(os.listdir(d)) == sorted(os.listdir(jd))
    assert os.path.basename(csv) == os.path.basename(jcsv) == "laplacian_results_float.csv"
    rows, jrows = open(csv).read().splitlines(), open(jcsv).read().splitlines()
    assert rows[0] == jrows[0] and len(rows) == len(jrows)
    assert [r.count(",") for r in rows] == [r.count(",") for r in jrows]
    assert open(os.path.join(d, "results_float.csv")).read() == open(csv).read()
    for g, jg in zip(graphs, jgraphs):
        assert os.path.basename(g) == os.path.basename(jg)
        lines, jlines = open(g).read().splitlines(), open(jg).read().splitlines()
        assert lines[0] == jlines[0] and lines[1].count("\t") == jlines[1].count("\t")


def test_convergence_analysis_graph_format(tmp_path):
    """tests/test_harness.py's first test: the reference's saveGraph
    layout (shape_from_shading/src/ConvergenceAnalysis.h:64-77), a row of
    timestamps, a row of costs, tab-separated; saving resets."""
    ca = th.ConvergenceAnalysis()
    for c in (10.0, 4.5, 2.25):
        ca.add_sample(c)
    p = tmp_path / "sfs.graph"
    ca.save_graph(str(p))
    rows = p.read_text().splitlines()
    assert rows[0].split("\t") == ["0", "1", "2"]
    assert [float(x) for x in rows[1].split("\t")] == [10.0, 4.5, 2.25]
    assert ca.samples == []
    jca = jh.ConvergenceAnalysis()
    for c in (10.0, 4.5, 2.25):
        jca.add_sample(c)
    jca.save_graph(str(tmp_path / "j.graph"))
    assert (tmp_path / "j.graph").read_text() == p.read_text()


def test_save_convergence_graphs_per_run(tmp_path):
    """tests/test_harness.py's second test: one graph a run, from its
    per-iteration costs."""

    class Dummy(th.CombinedSolverBase):
        def combined_solve_init(self):
            pass

    def myspec(S):
        pass

    s = Dummy(myspec, {}, {})
    for nm, costs in [("Opt(GN)", [3.0, 1.0]), ("Opt(LM)", [3.0, 0.5])]:
        run_ = th.SolverRun(name=nm)
        run_.iterations = [th.SolverIteration(c, 1.0) for c in costs]
        s.runs.append(run_)
    paths = s.save_convergence_graphs(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["myspec_Opt_GN_convergence.graph",
                                                    "myspec_Opt_LM_convergence.graph"]
    for p, costs in zip(paths, ([3.0, 1.0], [3.0, 0.5])):
        rows = open(p).read().splitlines()
        assert [float(x) for x in rows[1].split("\t")] == costs


def test_device_schedule_and_timing(capsys):
    """make_device_schedule runs the outer loop through solve_scheduled,
    its costs those of the host loop; collect_timing keeps the host loop
    and prints a TIMING table a solve."""
    host = solver_class(th.CombinedSolverBase, tlaplacian, "cpu")
    host.add_opt_solvers(["gaussNewtonGPU"])
    host.solve_all()
    sched = solver_class(th.CombinedSolverBase, tlaplacian, "cpu")
    start = lap_inputs()
    shifted = torch.as_tensor(np.roll(start["A"], 1, 0))
    A0 = torch.as_tensor(start["A"])

    def make_device_schedule(num_iter):
        def schedule(consts, i):
            a = (i.to(torch.float32) + 1.0) / num_iter
            return dict(consts, A=((1 - a) * A0 + a * shifted)[..., None])
        return schedule

    sched.make_device_schedule = make_device_schedule
    sched.add_opt_solvers(["gaussNewtonGPU"])
    sched.solve_all()
    np.testing.assert_allclose([i.cost for i in sched.runs[0].iterations],
                               [i.cost for i in host.runs[0].iterations], rtol=1e-6)
    assert "TIMING" not in capsys.readouterr().out
    timed = solver_class(th.CombinedSolverBase, tlaplacian, "cpu")
    timed.collect_timing = True
    timed.make_device_schedule = make_device_schedule
    timed.add_opt_solvers(["gaussNewtonGPU"])
    timed.solve_all()
    assert capsys.readouterr().out.count("TIMING ") == PARAMS["numIter"]
    assert [i.cost for i in timed.runs[0].iterations] == [i.cost for i in host.runs[0].iterations]


def test_pyramid_hook_replans():
    """A 2-level pre_nonlinear_solve hook that plans each level anew, as a
    pyramid does (coarse 6x6, then 12x12 from the coarse solution
    upsampled): each level's cost is bitwise that of a direct solve of the
    level's plan on the same inputs."""
    import opt_tpu_torch as ott

    def level_plan(dims):
        return ott.Problem(tlaplacian).plan(dims=dims, device="cpu", nIterations=3,
                                           lIterations=20)

    def upsample(x):
        x = np.asarray(x).reshape(N // 2, N // 2)
        return np.repeat(np.repeat(x, 2, 0), 2, 1)

    full = lap_inputs()
    coarse = {k: v[::2, ::2].copy() for k, v in full.items()}

    class Pyramid(th.CombinedSolverBase):
        device = "cpu"

        def combined_solve_init(self):
            pass

        def pre_single_solve(self):  # the solver starts at the coarse level
            self.problem_inputs = dict(coarse)

        def pre_nonlinear_solve(self, i):
            if i == 1:
                self.problem_inputs = {"X": upsample(self.problem_inputs["X"]),
                                       "A": full["A"]}
                self.plan = level_plan({"W": N, "H": N})

    s = Pyramid(tlaplacian, {"W": N // 2, "H": N // 2}, dict(PARAMS, nonLinearIter=3))
    s.add_opt_solvers(["gaussNewtonGPU"])
    s.solve_all()
    first = level_plan({"W": N // 2, "H": N // 2}).solve(dict(coarse))
    second = level_plan({"W": N, "H": N}).solve({"X": upsample(first.unknowns["X"]),
                                                 "A": full["A"]})
    assert [i.cost for i in s.runs[0].iterations] == [first.final_cost, second.final_cost]
    assert torch.equal(s.problem_inputs["X"], second.unknowns["X"])
