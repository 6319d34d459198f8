"""Seeded random-spec fuzzing of opt_tpu_torch's assembled JᵀJ against the
dense oracle and against the JAX package's assembled operator: the grid,
graph, 3-D and sampled-image fuzzers of tests/test_fuzz_operator.py at the
same seeds (8 + 4 + 3 + 2).

Each generator is written once and takes the DSL module (``opt_tpu`` or
``opt_tpu_torch``), so that one seed gives the same spec and the same
inputs in both packages. The port's assembled JᵀJ·p and Jacobi diagonal
are held to ``torch.func.jacfwd`` of its residuals, masked as the JAX
test masks (rtol 2e-3 / atol 1e-3; the diagonal 2e-3 / 1e-4), and to the
JAX package's assembled operator at 1e-5. Where the JAX package has no
assembly plan for a seed, the port must refuse it too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.assembly import assemble as jax_assemble
from opt_tpu.assembly import plan_assembly as jax_plan_assembly
from opt_tpu.functions import FunctionSet as JaxFunctionSet
from opt_tpu_torch.assembly import assemble as torch_assemble
from opt_tpu_torch.assembly import plan_assembly as torch_plan_assembly
from opt_tpu_torch.functions import FunctionSet as TorchFunctionSet

torch.set_num_threads(2)

N = 8  # grid side / vertex count
PARITY_RTOL, PARITY_ATOL = 1e-5, 1e-5  # port against the JAX package's operator


def _random_grid_spec(rng, dsl):
    """Random 2-D grid energy over 1-2 unknowns with gates/computed arrays."""
    n_unknowns = rng.randint(1, 3)
    u_ch = [int(rng.randint(1, 4)) for _ in range(n_unknowns)]
    thresholds = [float(t) for t in rng.uniform(-3, 3, 2)]
    offsets = [(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1), (1, 1)]
    n_terms = rng.randint(2, 5)
    term_cfg = []
    for _ in range(n_terms):
        term_cfg.append(
            {
                "u": int(rng.randint(0, n_unknowns)),
                "off": offsets[rng.randint(0, len(offsets))],
                "gate": int(rng.randint(0, 3)),  # 0 none, 1 const, 2 computed
                "thr": thresholds[rng.randint(0, 2)],
                "nonlin": int(rng.randint(0, 2)),
                "w": float(rng.uniform(0.2, 2.0)),
            }
        )
    use_exclude = bool(rng.randint(0, 2))
    use_computed = any(t["gate"] == 2 for t in term_cfg) or bool(rng.randint(0, 2))

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        U = [S.Unknown(f"X{i}", u_ch[i], (W, H)) for i in range(n_unknowns)]
        D = S.Array("D", 1, (W, H))
        A = S.Array("A", u_ch[0], (W, H))
        C = None
        if use_computed:
            C = S.ComputedArray("C", (W, H), lambda: U[0](0, 0) * U[0](0, 0) - A(0, 0))
        if use_exclude:
            S.Exclude(dsl.greater(D(0, 0), 2.5))
        for t in term_cfg:
            x = U[t["u"]]
            base = x(*t["off"]) - x(0, 0) * (0.5 if t["nonlin"] else 1.0)
            if t["nonlin"]:
                base = base + 0.1 * x(0, 0) * x(*t["off"])
            if t["gate"] == 1:
                base = dsl.Select(dsl.greater(D(0, 0), t["thr"]), t["w"] * base, 0.0)
            elif t["gate"] == 2 and C is not None:
                # gate on C's first channel so the 0/1 mask broadcasts
                # against any term channel count
                base = dsl.Select(dsl.less(dsl.Slice(C(0, 0), 0, 1), t["thr"]),
                                  t["w"] * base, 0.0)
            else:
                base = t["w"] * base
            S.Energy(base)
        # always at least one plain fit so the problem is well-posed
        S.Energy(0.3 * (U[0](0, 0) - A(0, 0)))

    inputs = {"D": rng.uniform(-4, 4, (N, N)).astype(np.float32)}
    inputs["A"] = rng.rand(N, N, u_ch[0]).astype(np.float32)
    for i in range(n_unknowns):
        inputs[f"X{i}"] = rng.rand(N, N, u_ch[i]).astype(np.float32)
    return spec, {"W": N, "H": N}, inputs


def _random_graph_spec(rng, dsl):
    """Random graph energy: 2-endpoint edges, gated couplings (a
    derangement: no self-loop edges, as tests/test_fuzz_operator.py says)."""
    ch = int(rng.randint(1, 4))
    thr = float(rng.uniform(-1, 1))
    nonlin = bool(rng.randint(0, 2))

    def spec(S):
        Nd = S.Dim("N")
        X = S.Unknown("X", ch, (Nd,))
        Dv = S.Array("Dv", 1, (Nd,))
        G = S.Graph("G", v0=(Nd,), v1=(Nd,))
        d = X(G.v0) - X(G.v1)
        if nonlin:
            d = d + 0.2 * X(G.v0) * X(G.v1)
        S.Energy(dsl.Select(dsl.greater(Dv(G.v0), thr), d, 0.0))
        S.Energy(0.4 * (X(0) - Dv(0)))

    rngE = np.random.RandomState(rng.randint(0, 1 << 30))
    v0 = np.arange(N, dtype=np.int32)
    v1 = rngE.permutation(N).astype(np.int32)
    while np.any(v1 == v0):
        v1 = rngE.permutation(N).astype(np.int32)
    inputs = {
        "X": rng.rand(N, ch).astype(np.float32),
        "Dv": rng.uniform(-2, 2, (N,)).astype(np.float32),
        "G": {"v0": v0, "v1": v1},
    }
    return spec, {"N": N}, inputs


def _random_3d_spec(rng, dsl):
    """Random 3-D grid energy (volumetric-style stencils + gates)."""
    ch = int(rng.randint(1, 4))
    thr = float(rng.uniform(-1.5, 1.5))
    offsets = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0)]
    picked = [offsets[rng.randint(0, 4)] for _ in range(2)]
    nonlin = bool(rng.randint(0, 2))

    def spec(S):
        W, H, D = S.Dim("W"), S.Dim("H"), S.Dim("D")
        X = S.Unknown("X", ch, (W, H, D))
        A = S.Array("A", ch, (W, H, D))
        M = S.Array("M", 1, (W, H, D))
        for off in picked:
            d = X(0, 0, 0) - X(*off)
            if nonlin:
                d = d + 0.1 * X(0, 0, 0) * X(*off)
            S.Energy(dsl.Select(dsl.greater(M(0, 0, 0), thr), d, 0.0))
        S.Energy(0.5 * (X(0, 0, 0) - A(0, 0, 0)))

    n = 5
    inputs = {
        "X": rng.rand(n, n, n, ch).astype(np.float32),
        "A": rng.rand(n, n, n, ch).astype(np.float32),
        "M": rng.uniform(-2, 2, (n, n, n)).astype(np.float32),
    }
    return spec, {"W": n, "H": n, "D": n}, inputs


def _sampled_image_spec(rng, dsl):
    """Flow-style spec: bilinear SampledImage at unknown-dependent coords."""
    del dsl  # the spec reads no DSL function
    wf = float(rng.uniform(0.5, 2.0))

    def spec(S):
        W, H = S.Dim("W"), S.Dim("H")
        X = S.Unknown("X", 2, (W, H))
        I = S.Array("I", 1, (W, H))  # noqa: E741
        Ih = S.Array("Ih", 1, (W, H))
        Ihx = S.Array("Ihx", 1, (W, H))
        Ihy = S.Array("Ihy", 1, (W, H))
        samp = S.SampledImage(Ih, Ihx, Ihy)
        i, j = S.Index(0), S.Index(1)
        S.Energy(wf * (I(0, 0) - samp(i[..., 0] + X(0, 0)[..., 0], j[..., 0] + X(0, 0)[..., 1])))
        S.Energy(0.3 * (X(0, 0) - X(1, 0)))

    inputs = {
        "X": (0.2 * rng.randn(N, N, 2)).astype(np.float32),
        "I": rng.rand(N, N).astype(np.float32),
        "Ih": rng.rand(N, N).astype(np.float32),
        "Ihx": (0.1 * rng.randn(N, N)).astype(np.float32),
        "Ihy": (0.1 * rng.randn(N, N)).astype(np.float32),
    }
    return spec, {"W": N, "H": N}, inputs


def _jax_operator(spec, dims, inputs, p):
    """The JAX package's assembled (diagonal, JᵀJ·p), flat in sorted unknown
    order, or None where it has no assembly plan."""
    plan = ot.Problem(spec).plan(dims=dims)
    c = plan.compiled
    unknowns, consts, graphs_in, params = c.normalize_inputs(inputs)
    graphs = plan._augment_incidence(graphs_in)
    fs = JaxFunctionSet(c, consts, graphs, params)
    fs.masks(unknowns)
    _, row_masks = fs._mask_cache
    spec_plan = jax_plan_assembly(spec, c)
    if spec_plan is None:
        return None
    apply_fn, diag, _jtf, _meta = jax_assemble(c, spec_plan, unknowns, consts, graphs, params,
                                               row_masks)
    names = sorted(unknowns)
    pd, o = {}, 0
    for n in names:
        sz = int(np.prod(unknowns[n].shape))
        pd[n] = jnp.asarray(p[o: o + sz]).reshape(unknowns[n].shape)
        o += sz
    out = apply_fn(pd)
    return (np.concatenate([np.asarray(diag[n]).ravel() for n in names]),
            np.concatenate([np.asarray(out[n]).ravel() for n in names]))


def _torch_dense_check(spec, dims, inputs, p):
    """The port's assembled (diagonal, JᵀJ·p) held to the dense oracle, or
    None where it has no assembly plan."""
    plan = ott.Problem(spec).plan(dims=dims, device="cpu")
    c = plan.compiled
    unknowns, consts, graphs_in, params = c.normalize_inputs(inputs, device="cpu")
    graphs = plan._augment_incidence(graphs_in)
    fs = TorchFunctionSet(c, consts, graphs, params)
    names = sorted(unknowns)
    shapes = [tuple(unknowns[n].shape) for n in names]
    sizes = [int(np.prod(s)) for s in shapes]

    def unflatten(v):
        out, o = {}, 0
        for n, s, sz in zip(names, shapes, sizes):
            out[n] = v[o: o + sz].reshape(s)
            o += sz
        return out

    def r_flat(v):
        return torch.cat([t.reshape(-1) for t in fs.F(unflatten(v))])

    x0 = torch.cat([unknowns[n].reshape(-1) for n in names])
    J = torch.func.jacfwd(r_flat)(x0).numpy()
    _excl, row_masks = fs.masks(unknowns)
    colmask = torch.cat([
        (torch.ones_like(unknowns[n]) if row_masks.get(n) is None
         else row_masks[n].expand(unknowns[n].shape).to(unknowns[n].dtype)).reshape(-1)
        for n in names]).numpy()
    Jm = J * colmask[None, :]

    spec_plan = torch_plan_assembly(spec, c)
    if spec_plan is None:
        return None
    apply_fn, diag, _jtf, _meta = torch_assemble(c, spec_plan, unknowns, consts, graphs, params,
                                                 row_masks)
    diag_flat = torch.cat([diag[n].reshape(-1) for n in names]).numpy()
    np.testing.assert_allclose(diag_flat, (Jm * Jm).sum(axis=0), rtol=2e-3, atol=1e-4)
    out = apply_fn(unflatten(torch.as_tensor(p)))
    got = torch.cat([out[n].reshape(-1) for n in names]).numpy()
    want = Jm.T @ (Jm @ (p * colmask))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-3)
    return diag_flat, got


def _check(make, seed):
    """One seed's spec in both packages: the port against the dense oracle
    and against the JAX package's operator; both refuse or both assemble."""
    spec_j, dims, inputs_j = make(np.random.RandomState(seed), ot)
    spec_t, dims_t, inputs_t = make(np.random.RandomState(seed), ott)
    assert dims_t == dims
    size = sum(int(np.prod(v.shape)) for k, v in inputs_t.items() if k.startswith("X"))
    p = np.random.RandomState(7).rand(size).astype(np.float32)
    ref = _jax_operator(spec_j, dims, inputs_j, p)
    got = _torch_dense_check(spec_t, dims, inputs_t, p)
    assert (got is None) == (ref is None), ("the port", got is None, "the JAX package",
                                            ref is None)
    if ref is not None:
        np.testing.assert_allclose(got[0], ref[0], rtol=PARITY_RTOL, atol=PARITY_ATOL)
        np.testing.assert_allclose(got[1], ref[1], rtol=PARITY_RTOL, atol=PARITY_ATOL)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_grid_assembled_jtj(seed):
    _check(_random_grid_spec, 1000 + seed)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_graph_assembled_jtj(seed):
    _check(_random_graph_spec, 2000 + seed)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_3d_assembled_jtj(seed):
    _check(_random_3d_spec, 3000 + seed)


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_sampled_image_assembled_jtj(seed):
    _check(_sampled_image_spec, 4000 + seed)
