"""Checkpoint/resume of the port (opt_tpu_torch/utils/checkpoint.py) held
to the JAX package's (tests/test_checkpoint.py): saving mid-solve and
restoring into a fresh plan reproduces the uninterrupted solve bit for
bit; a checkpoint written by either package restores into the other and
resumes to the same result; on a 2x2 mesh of gloo CPU ranks the resume is
bitwise the mesh's uninterrupted solve.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import opt_tpu as ot
import opt_tpu_torch as ott
from opt_tpu.utils import checkpoint as jcheckpoint
from opt_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16


def _laplacian(S):
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    S.Energy(0.2 * (X(0, 0) - A(0, 0)), X(0, 0) - X(1, 0), X(0, 0) - X(0, 1))


def _inputs(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return {"X": rng.rand(n, n).astype(np.float32), "A": rng.rand(n, n).astype(np.float32)}


def _run(plan, inputs, n_steps):
    plan.init(inputs)
    for _ in range(n_steps):
        plan.step()
    return plan


def _port_plan(n=N, kind="LMGPU", **sp):
    return ott.Problem(_laplacian, kind=kind).plan(dims={"W": n, "H": n}, device="cpu",
                                                  nIterations=6, lIterations=10, **sp)


def _jax_plan(n=N, kind="LMGPU"):
    return ot.Problem(_laplacian, kind=kind).plan(dims={"W": n, "H": n}, nIterations=6,
                                                 lIterations=10)


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    """test_checkpoint.py:26 (its npz case): 3 steps, save, restore into a
    FRESH plan, 3 more: bitwise the uninterrupted 6."""
    inputs = _inputs()
    ref = _run(_port_plan(), dict(inputs), 6)
    half = _run(_port_plan(), dict(inputs), 3)
    path = checkpoint.save(str(tmp_path / "ckpt"), half, use_orbax=False)
    fresh = _port_plan()
    state = checkpoint.restore(path, fresh, inputs=dict(inputs))
    assert fresh.current_cost() == half.current_cost()
    assert {k: v.dtype for k, v in state.items() if isinstance(v, torch.Tensor)} == {
        k: v.dtype for k, v in half._state.items() if isinstance(v, torch.Tensor)}
    for _ in range(3):
        fresh.step()
    assert torch.equal(fresh.unknowns["X"], ref.unknowns["X"])
    assert fresh.current_cost() == ref.current_cost()
    assert int(fresh._state["lin_iters"]) == int(ref._state["lin_iters"])


def test_orbax_is_refused(tmp_path):
    """orbax is a JAX library: the port writes npz only."""
    plan = _run(_port_plan(8), _inputs(8), 1)
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.save(str(tmp_path / "o"), plan, use_orbax=True)


def test_checkpoint_rejects_mismatched_plan(tmp_path):
    """test_checkpoint.py:89: other dims, or another kind."""
    plan = ott.Problem(_laplacian).plan(dims={"W": N, "H": N}, device="cpu", nIterations=2)
    plan.init(_inputs())
    path = checkpoint.save(str(tmp_path / "c2"), plan)
    other = ott.Problem(_laplacian).plan(dims={"W": 8, "H": 8}, device="cpu")
    with pytest.raises(ValueError, match="dims"):
        checkpoint.restore(path, other)
    with pytest.raises(ValueError, match="kind"):
        checkpoint.restore(path, _port_plan(kind="LMGPU"))


def test_restore_fresh_plan_without_inputs_raises(tmp_path):
    """test_checkpoint.py:105: a fresh plan has no bound constants, so
    restore without inputs fails fast with the remedy."""
    n = 8
    inputs = _inputs(n, 3)
    plan = ott.Problem(_laplacian).plan(dims={"W": n, "H": n}, device="cpu", nIterations=2)
    plan.init(dict(inputs))
    plan.step()
    path = checkpoint.save(str(tmp_path / "c3"), plan)
    fresh = ott.Problem(_laplacian).plan(dims={"W": n, "H": n}, device="cpu", nIterations=2)
    with pytest.raises(RuntimeError, match="inputs"):
        checkpoint.restore(path, fresh)
    checkpoint.restore(path, fresh, inputs=dict(inputs))
    fresh.step()


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the JAX package wrote (laplacian LM, 3 steps) restores
    into the port's plan; its next 3 steps match the JAX package's
    uninterrupted 6 at 1e-6, with the same counts."""
    inputs = _inputs(seed=1)
    jref = _run(_jax_plan(), dict(inputs), 6)
    jhalf = _run(_jax_plan(), dict(inputs), 3)
    path = jcheckpoint.save(str(tmp_path / "jax"), jhalf, use_orbax=False)
    fresh = _port_plan()
    checkpoint.restore(path, fresh, inputs=dict(inputs))
    assert fresh.current_cost() == jhalf.current_cost()
    for _ in range(3):
        fresh.step()
    np.testing.assert_allclose(fresh.unknowns["X"].numpy(), np.asarray(jref.unknowns["X"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(fresh.current_cost(), jref.current_cost(), rtol=1e-6)
    for k in ("n_iter", "lin_iters"):
        assert int(fresh._state[k]) == int(jref._state[k])


def test_port_checkpoint_resumes_in_the_jax_package(tmp_path):
    """The reverse: the port's checkpoint (3 steps) restores into a JAX
    plan, whose next 3 steps match the port's uninterrupted 6 at 1e-6."""
    inputs = _inputs(seed=2)
    ref = _run(_port_plan(), dict(inputs), 6)
    half = _run(_port_plan(), dict(inputs), 3)
    path = checkpoint.save(str(tmp_path / "port"), half)
    jfresh = _jax_plan()
    jcheckpoint.restore(path, jfresh, inputs=dict(inputs))
    assert jfresh.current_cost() == half.current_cost()
    for _ in range(3):
        jfresh.step()
    np.testing.assert_allclose(np.asarray(jfresh.unknowns["X"]), ref.unknowns["X"].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(jfresh.current_cost(), ref.current_cost(), rtol=1e-6)
    for k in ("n_iter", "lin_iters"):
        assert int(jfresh._state[k]) == int(ref._state[k])


MESH_WORKER = r'''
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
import opt_tpu_torch as ot
from opt_tpu_torch.models.specs import laplacian
from opt_tpu_torch.parallel import initialize, make_mesh
from opt_tpu_torch.utils import checkpoint

rank, world, store, out_dir = sys.argv[1:5]
rank, world = int(rank), int(world)
initialize("file://" + store, world_size=world, rank=rank, backend="gloo")
mesh = make_mesh(device="cpu")
n = 32
rng = np.random.RandomState(0)
inputs = {{"X": rng.rand(n, n).astype("f4"), "A": rng.rand(n, n).astype("f4")}}


def mk():
    return ot.Problem(laplacian, kind="LMGPU").plan(dims={{"W": n, "H": n}}, mesh=mesh,
                                                    device="cpu", nIterations=6,
                                                    lIterations=10)


def run(plan, steps):
    plan.init(dict(inputs))
    for _ in range(steps):
        plan.step()
    return plan


ref = run(mk(), 6)
ref_x = ref.unknowns["X"]
half = run(mk(), 3)
path = checkpoint.save(out_dir + "/ckpt", half)
fresh = mk()
checkpoint.restore(path, fresh, inputs=dict(inputs))
region = list(fresh._state["X"]["X"].shape)
report = fresh.dump_hlo(dict(inputs))
for _ in range(3):
    fresh.step()
out = {{"equal": bool(torch.equal(fresh.unknowns["X"], ref_x)),
        "cost_equal": fresh.current_cost() == ref.current_cost(),
        "lin_equal": int(fresh._state["lin_iters"]) == int(ref._state["lin_iters"]),
        "region": region, "tile": [list(t) for t in fresh.rules.tile],
        "report": report}}
with open(out_dir + f"/rank{{rank}}.json", "w") as f:
    json.dump(out, f)
'''


def test_mesh_checkpoint_resume(tmp_path):
    """test_checkpoint.py:58 on the port's 2x2 mesh of gloo CPU ranks: save
    from a mesh plan mid-solve (the global unknowns, gathered), restore into
    a fresh mesh plan (each rank its region) and continue: bitwise the
    mesh's uninterrupted solve on every rank. The restored plan's report
    (dump_hlo, every rank together) names the sharded loop and K5."""
    script = tmp_path / "worker.py"
    script.write_text(MESH_WORKER.format(repo=REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "4", str(tmp_path / "store"),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(4)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(4)]
    for r in ranks:
        assert r["equal"] and r["cost_equal"] and r["lin_equal"], r
        # each rank holds its extended region, not the global grid
        assert r["region"][:2] != [32, 32] and r["region"][2] == 1, r
    assert len({json.dumps(r["tile"]) for r in ranks}) == 4
    # the plan report of a mesh plan, on each rank: the sharded loop and K5
    for r in ranks:
        assert "path: sharded loop" in r["report"] and "tile_apply_kernel<float>" in r["report"]
