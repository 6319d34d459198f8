"""opt_tpu_torch's Jacobian export (jacobian.py, Plan.dump_jacobian) held to
opt_tpu's on the same inputs, on five specs: poisson_image_editing and
image_warping with a mask (excluded unknowns), arap_mesh_deformation,
curve_fitting, and a graph coupling two vertex spaces. The COO, its
duplicates summed, equals the JAX package's at 1e-6; the dense form equals
the ``torch.func.jacfwd`` oracle of the flattened residuals
(tests/test_torch_core.py::dense_system), its columns in the order of
``compiled.unknown_names``."""

import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from chip_smoke import arap_grid_inputs, bench_image_warping_inputs, bench_poisson_inputs
from opt_tpu.models import specs as jspecs
from opt_tpu_torch.models import specs as tspecs
from tests.test_torch_core import dense_system
from tests.test_torch_cross_space import two_space_inputs, two_space_spec

torch.set_num_threads(2)

f32 = np.float32


def _warp_inputs(n=8):
    inputs = bench_image_warping_inputs(n)
    inputs["Mask"][n // 4 : n // 2, n // 4 : n // 2] = 1.0  # an excluded block
    return {"W": n, "H": n}, inputs


def _curve_inputs(N=16):
    rng = np.random.RandomState(3)
    xs = rng.rand(N) * 0.1
    ys = 100.0 * np.cos(102.0 * xs) + 102.0 * np.sin(100.0 * xs)
    return {"N": N, "U": 1}, {
        "funcParams": np.array([[99.6, 102.4]], f32),
        "data": np.stack([xs, ys], -1).astype(f32),
        "G": {"d": np.arange(N, dtype=np.int32), "p": np.zeros(N, np.int32)}}


CASES = {
    "poisson": (jspecs.poisson_image_editing, tspecs.poisson_image_editing,
                lambda: ({"W": 8, "H": 8}, bench_poisson_inputs(8))),
    "image_warping": (jspecs.image_warping, tspecs.image_warping, _warp_inputs),
    "arap": (jspecs.arap_mesh_deformation, tspecs.arap_mesh_deformation,
             lambda: arap_grid_inputs(4)),
    "curve_fitting": (jspecs.curve_fitting, tspecs.curve_fitting, _curve_inputs),
    "two_space": (two_space_spec(ot), two_space_spec(ott), lambda: two_space_inputs(16, 4, 40)),
}


def _dense(coo):
    J = np.zeros(coo["shape"])
    np.add.at(J, (coo["rows"], coo["cols"]), np.asarray(coo["vals"], np.float64))
    return J


@pytest.mark.parametrize("name", sorted(CASES))
def test_coo_matches_jax(name):
    jspec, tspec, make = CASES[name]
    dims, inputs = make()
    jc = ot.Problem(jspec).plan(dims=dims).dump_jacobian(dict(inputs))
    tplan = ott.Problem(tspec).plan(dims=dims, device="cpu")
    tc = tplan.dump_jacobian(dict(inputs))
    assert tc["shape"] == tuple(jc["shape"]) and tc["row_offsets"] == list(jc["row_offsets"])
    assert isinstance(tc["rows"], np.ndarray) and isinstance(tc["vals"], np.ndarray)
    jd, td = _dense(jc), _dense(tc)
    assert np.abs(td - jd).max() <= 1e-6 * np.abs(jd).max()
    # the same entries: the JAX package drops the zeros as the port does
    assert len(tc["vals"]) == len(jc["vals"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_matches_jacfwd(name):
    _jspec, tspec, make = CASES[name]
    dims, inputs = make()
    plan = ott.Problem(tspec).plan(dims=dims, device="cpu")
    dense = plan.dump_jacobian(dict(inputs), dense=True)
    _fs, unknowns, _x0, J, _colmask = dense_system(plan, dict(inputs))
    # dense_system orders its columns by sorted unknown name
    sizes = {k: unknowns[k].numel() for k in unknowns}
    starts, o = {}, 0
    for k in sorted(unknowns):
        starts[k] = o
        o += sizes[k]
    perm = np.concatenate([np.arange(starts[k], starts[k] + sizes[k])
                           for k in plan.compiled.unknown_names])
    oracle = J[:, perm]
    assert dense.shape == oracle.shape
    np.testing.assert_allclose(dense, oracle, rtol=0, atol=1e-5 * np.abs(oracle).max())
