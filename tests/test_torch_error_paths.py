"""Named errors on user mistakes, through opt_tpu_torch: the nine cases of
tests/test_error_paths.py on the port's plans (on the CPU), with the same
exception types and messages — the failure modes MANUAL.md "Common
problems" documents and the reference's own DSL checks (mixed domains
o.t:1916, no-image residuals o.t:1922, the string→field parameter chain
solverGPUGaussNewton.t:1205-1221 which silently ignores nothing)."""

import numpy as np
import pytest

import opt_tpu_torch as ot
from opt_tpu_torch.spec import SpecError


def _lap(S):
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    S.Energy(0.2 * (X(0, 0) - A(0, 0)), X(0, 0) - X(1, 0))


def _inputs(n=8):
    rng = np.random.RandomState(0)
    return {"X": np.zeros((n, n), np.float32),
            "A": rng.rand(n, n).astype(np.float32)}


def test_typod_solver_parameter():
    plan = ot.Problem(_lap).plan(dims={"W": 8, "H": 8}, device="cpu")
    with pytest.raises(KeyError, match="nIterationz"):
        plan.set_solver_parameter("nIterationz", 3)
    with pytest.raises(KeyError):
        plan.solve(_inputs(), nIterationz=3)


def test_missing_input():
    plan = ot.Problem(_lap).plan(dims={"W": 8, "H": 8}, device="cpu")
    with pytest.raises(SpecError, match="missing inputs"):
        plan.solve({"X": np.zeros((8, 8), np.float32)})


def test_unknown_input_name():
    plan = ot.Problem(_lap).plan(dims={"W": 8, "H": 8}, device="cpu")
    with pytest.raises(SpecError, match="unknown input"):
        plan.solve({**_inputs(), "Bogus": np.zeros((8, 8), np.float32)})


def test_misshaped_input():
    plan = ot.Problem(_lap).plan(dims={"W": 8, "H": 8}, device="cpu")
    bad = dict(_inputs())
    bad["A"] = np.zeros((4, 4), np.float32)
    with pytest.raises(SpecError, match="expected shape"):
        plan.solve(bad)


def test_no_energy_terms():
    def empty(S):
        W, H = S.Dim("W"), S.Dim("H")
        S.Unknown("X", 1, (W, H))

    with pytest.raises(SpecError, match="no Energy terms"):
        ot.Problem(empty).plan(dims={"W": 8, "H": 8}, device="cpu")


def test_residual_without_image_reads():
    def scalar_only(S):
        W, H = S.Dim("W"), S.Dim("H")
        S.Unknown("X", 1, (W, H))
        w = S.Param("w")
        S.Energy(w * 2.0)

    with pytest.raises(SpecError, match="must actually use"):
        ot.Problem(scalar_only).plan(dims={"W": 8, "H": 8}, device="cpu")


def test_mixed_grid_and_graph_domains():
    def mixed(S):
        W, H = S.Dim("W"), S.Dim("H")
        N = S.Dim("N")
        X = S.Unknown("X", 1, (W, H))
        Y = S.Unknown("Y", 1, (N,))
        G = S.Graph("G", v0=(N,))
        S.Energy(X(0, 0) - Y(G.v0)[..., 0])

    with pytest.raises(SpecError, match="multiple domains"):
        ot.Problem(mixed).plan(dims={"W": 8, "H": 8, "N": 8}, device="cpu")


def test_graph_missing_slot_access():
    def g(S):
        N = S.Dim("N")
        X = S.Unknown("X", 1, (N,))
        G = S.Graph("G", v0=(N,))
        S.Energy(X(G.v9))

    with pytest.raises(SpecError, match="no slot"):
        ot.Problem(g).plan(dims={"N": 8}, device="cpu")


def test_step_before_init():
    plan = ot.Problem(_lap).plan(dims={"W": 8, "H": 8}, device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        plan.step()
    with pytest.raises(RuntimeError, match="init"):
        plan.current_cost()
