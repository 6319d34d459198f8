"""opt_tpu_torch compile stage held to opt_tpu: slot tables, residual
classification (domain, bbox, uses_bounds, channels), residual values,
exclusion/row masks and the named errors, on the same numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.compile import compile_spec as j_compile
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.compile import compile_spec as t_compile
from opt_tpu_torch.models import specs as tspecs

torch.set_num_threads(2)

SPECS = ["laplacian", "poisson_image_editing"]


def _inputs(name, n0, n1, seed=0):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    if name == "laplacian":
        return {"X": rng.rand(n0, n1).astype(f32), "A": rng.rand(n0, n1).astype(f32)}
    return {
        "X": rng.rand(n0, n1, 4).astype(f32),
        "T": rng.rand(n0, n1, 4).astype(f32),
        "M": (rng.rand(n0, n1) > 0.5).astype(f32),
    }


def _pair(name, dims):
    jc = j_compile(getattr(jspecs, name), dims, jnp.float32)
    tc = t_compile(getattr(tspecs, name), dims, torch.float32)
    return jc, tc


def _isp_names(isp):
    return tuple(d.name for d in isp.dims)


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("dims", [{"W": 12, "H": 12}, {"W": 9, "H": 7}])
def test_classification_matches(name, dims):
    jc, tc = _pair(name, dims)
    js, ts = jc.registry.slots, tc.registry.slots
    assert [(s.kind, s.image, s.offset, s.expand, s.channels, s.is_unknown) for s in js] == [
        (s.kind, s.image, s.offset, s.expand, s.channels, s.is_unknown) for s in ts
    ]
    assert len(jc.terms) == len(tc.terms)
    for jt, tt in zip(jc.terms, tc.terms):
        assert jt.slot_ids == tt.slot_ids
        assert jt.domain[0] == tt.domain[0]
        assert _isp_names(jt.domain[1]) == _isp_names(tt.domain[1])
        assert jt.bbox == tt.bbox
        assert jt.uses_bounds == tt.uses_bounds
        assert jt.channels == tt.channels
    assert [(e.slot_ids, _isp_names(e.ispace)) for e in jc.registry.exclude_terms] == [
        (e.slot_ids, _isp_names(e.ispace)) for e in tc.registry.exclude_terms
    ]
    assert jc.use_preconditioner == tc.use_preconditioner


@pytest.mark.parametrize("name", SPECS)
def test_residuals_and_masks_match(name):
    dims = {"W": 10, "H": 13}
    jc, tc = _pair(name, dims)
    inputs = _inputs(name, 10, 13)
    ju, jcs, jg, jp = jc.normalize_inputs(inputs)
    tu, tcs, tg, tp = tc.normalize_inputs(inputs, device="cpu")
    jr = jc.residual_terms(ju, jcs, jg, jp)
    tr = tc.residual_terms(tu, tcs, tg, tp)
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        # same f32 elementwise arithmetic; 1e-6 absorbs XLA's fusion reorder
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    je = jc.exclusion_masks(ju, jcs, jg, jp)
    te = tc.exclusion_masks(tu, tcs, tg, tp)
    assert sorted(map(_isp_names, je)) == sorted(map(_isp_names, te))
    for isp, m in je.items():
        (tm,) = [v for k, v in te.items() if _isp_names(k) == _isp_names(isp)]
        np.testing.assert_array_equal(tm.numpy(), np.asarray(m))  # 0/1: exact
    jrm, trm = jc.unknown_row_masks(je), tc.unknown_row_masks(te)
    assert sorted(jrm) == sorted(trm)
    for k in jrm:
        assert (jrm[k] is None) == (trm[k] is None)
        if jrm[k] is not None:
            np.testing.assert_array_equal(trm[k].numpy(), np.asarray(jrm[k]))


def test_shape_only_ops_add_no_dependence():
    """zeros_like of a shifted read must not put that slot into the term:
    a jaxpr sees a literal broadcast, an FX graph an op taking the tensor."""

    def j_spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(X(0, 0) - A(0, 0) + jnp.zeros_like(X(2, 0)), X(0, 0) - X(0, 1))

    def t_spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(X(0, 0) - A(0, 0) + torch.zeros_like(X(2, 0)), X(0, 0) - X(0, 1))

    dims = {"W": 8, "H": 8}
    jc = j_compile(j_spec, dims, jnp.float32)
    tc = t_compile(t_spec, dims, torch.float32)
    for jt, tt in zip(jc.terms, tc.terms):
        assert jt.slot_ids == tt.slot_ids
        assert jt.bbox == tt.bbox
    assert tc.terms[0].bbox == ((0, 0), (0, 0))


def _plan(pkg, spec, dims):
    """pkg's plan of ``spec``; the port's on the CPU, where these tests run."""
    kw = {"device": "cpu"} if pkg is ott else {}
    return pkg.Problem(spec).plan(dims=dims, **kw)


def _lap_inputs(n=8):
    rng = np.random.RandomState(0)
    return {"X": np.zeros((n, n), np.float32), "A": rng.rand(n, n).astype(np.float32)}


def _err_lap(pkg):
    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 1, (W, H))
        A = S.Array("A", 1, (W, H))
        S.Energy(0.2 * (X(0, 0) - A(0, 0)), X(0, 0) - X(1, 0))

    return spec


def _case_missing_input(pkg):
    plan = _plan(pkg, _err_lap(pkg), {"W": 8, "H": 8})
    plan.solve({"X": np.zeros((8, 8), np.float32)})


def _case_unknown_input(pkg):
    plan = _plan(pkg, _err_lap(pkg), {"W": 8, "H": 8})
    plan.solve({**_lap_inputs(), "Bogus": np.zeros((8, 8), np.float32)})


def _case_misshaped_input(pkg):
    plan = _plan(pkg, _err_lap(pkg), {"W": 8, "H": 8})
    bad = dict(_lap_inputs())
    bad["A"] = np.zeros((4, 4), np.float32)
    plan.solve(bad)


def _case_no_energy(pkg):
    def empty(S):
        W, H = S.Dim("W"), S.Dim("H")
        S.Unknown("X", 1, (W, H))

    _plan(pkg, empty, {"W": 8, "H": 8})


def _case_no_image_reads(pkg):
    def scalar_only(S):
        W, H = S.Dim("W"), S.Dim("H")
        S.Unknown("X", 1, (W, H))
        w = S.Param("w")
        S.Energy(w * 2.0)

    _plan(pkg, scalar_only, {"W": 8, "H": 8})


def _case_mixed_domains(pkg):
    def mixed(S):
        W, H = S.Dim("W"), S.Dim("H")
        N = S.Dim("N")
        X = S.Unknown("X", 1, (W, H))
        Y = S.Unknown("Y", 1, (N,))
        G = S.Graph("G", v0=(N,))
        S.Energy(X(0, 0) - Y(G.v0)[..., 0])

    _plan(pkg, mixed, {"W": 8, "H": 8, "N": 8})


def _case_graph_missing_slot(pkg):
    def g(S):
        N = S.Dim("N")
        X = S.Unknown("X", 1, (N,))
        G = S.Graph("G", v0=(N,))
        S.Energy(X(G.v9))

    _plan(pkg, g, {"N": 8})


def _case_typod_parameter(pkg):
    plan = _plan(pkg, _err_lap(pkg), {"W": 8, "H": 8})
    plan.set_solver_parameter("nIterationz", 3)


def _case_typod_solve_parameter(pkg):
    plan = _plan(pkg, _err_lap(pkg), {"W": 8, "H": 8})
    plan.solve(_lap_inputs(), nIterationz=3)


def _case_step_before_init(pkg):
    _plan(pkg, _err_lap(pkg), {"W": 8, "H": 8}).step()


def _case_cost_before_init(pkg):
    _plan(pkg, _err_lap(pkg), {"W": 8, "H": 8}).current_cost()


ERROR_CASES = {
    # case: (error kind, message pattern) — test_error_paths.py's cases
    "missing_input": (_case_missing_input, "spec", "missing inputs"),
    "unknown_input": (_case_unknown_input, "spec", "unknown input"),
    "misshaped_input": (_case_misshaped_input, "spec", "expected shape"),
    "no_energy": (_case_no_energy, "spec", "no Energy terms"),
    "no_image_reads": (_case_no_image_reads, "spec", "must actually use"),
    "mixed_domains": (_case_mixed_domains, "spec", "multiple domains"),
    "graph_missing_slot": (_case_graph_missing_slot, "spec", "no slot"),
    "typod_parameter": (_case_typod_parameter, KeyError, "nIterationz"),
    "typod_solve_parameter": (_case_typod_solve_parameter, KeyError, "nIterationz"),
    "step_before_init": (_case_step_before_init, RuntimeError, "init"),
    "cost_before_init": (_case_cost_before_init, RuntimeError, "init"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_named_errors_match(case):
    fn, kind, pattern = ERROR_CASES[case]
    for pkg in (ot, ott):
        exc = pkg.SpecError if kind == "spec" else kind
        with pytest.raises(exc, match=pattern):
            fn(pkg)
