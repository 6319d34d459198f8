"""K5, the sharded solve's per-tile apply (ops/csrc/tile_apply.cu), as its
threads cut the tile: a model of the kernel's partition in plain PyTorch
(:func:`emulate`), held bitwise to the plain twin
(``sharded_cg.tile_apply_reference``) and to the whole grid's apply cropped
to the tile, and to the JAX package's Pallas tile kernel in interpret mode.

The model reads the kernel's block width and rows a thread (TA_BLOCK,
TA_ROWS) from its source and walks its grid: a thread a channel of one
column over TA_ROWS rows, each triple's flat source place in p_ext and its
field as the C launch puts them into the kernel's parameter from
``sharded_cg._launch_table``'s host arrays, each channel's sum in the
table's order from 0. Every flat read is checked to land in the plane and
row the stencil names. The CUDA kernel itself runs only on the card
(``chip_smoke.py::tile_checks``)."""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as tF
from jax.experimental import pallas as pl

import opt_tpu_torch as ott
from opt_tpu.ops.pallas_cg import _tile_apply_kernel
from opt_tpu_torch.models import specs as tspecs
from opt_tpu_torch.ops import sharded_cg
from opt_tpu_torch.ops.fused_cg import _stencil_apply
from opt_tpu_torch.parallel.mesh import split_bounds

torch.set_num_threads(2)
f32 = np.float32


def biharmonic(S):  # a radius-2 stencil: a halo of 2
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    S.Energy(0.3 * (X(0, 0) - A(0, 0)))
    for dx, dy in ott.Stencil([(2, 0), (-2, 0), (0, 2), (0, -2)]):
        S.Energy(ott.Select(ott.InBounds(dx, dy), X(0, 0) - X(dx, dy), 0.0))


def _inputs(name, h, w):
    rng = np.random.RandomState(0)
    if name == "poisson":
        mask = np.ones((h, w), f32)
        mask[4:-4, 4:-4] = 0
        return {"X": rng.rand(h, w, 4).astype(f32), "T": rng.rand(h, w, 4).astype(f32),
                "M": mask}
    if name == "biharmonic":
        return {"X": rng.rand(h, w).astype(f32), "A": rng.rand(h, w).astype(f32)}
    ur = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1).astype(f32)
    con = -np.ones((h, w, 2), f32)
    for _ in range(6):
        i, j = rng.randint(0, h, 2)
        con[i, j] = [i + rng.randn(), j + rng.randn()]
    return {"Offset": ur.copy(), "Angle": np.zeros((h, w), f32), "UrShape": ur,
            "Constraints": con, "Mask": np.zeros((h, w), f32),
            "w_fitSqrt": np.sqrt(100.0).astype(f32), "w_regSqrt": np.sqrt(0.01).astype(f32)}


# case: (spec, its inputs, grid (H, W), InitializationParameters)
CASES = {
    "poisson": (tspecs.poisson_image_editing, "poisson", (32, 32), {}),
    "image_warping": (tspecs.image_warping, "image_warping", (32, 32), {}),
    "radius2": (biharmonic, "biharmonic", (32, 32), {}),
    "bf16": (tspecs.poisson_image_editing, "poisson", (32, 32),
             {"coefficient_dtype": "bfloat16"}),
    "uneven": (tspecs.poisson_image_editing, "poisson", (33, 32), {}),
}


@functools.lru_cache(maxsize=None)
def _meta(case):
    spec, inp, (h, w), ip = CASES[case]
    plan = ott.Problem(spec).plan(dims={"W": h, "H": w}, device="cpu",
                                  init_params=ott.InitializationParameters(**ip))
    meta, *_ = plan.cg_inputs(_inputs(inp, h, w))
    return meta


def _tiles(meta, seed=3):
    """The four tiles of a 2x2 split of the meta's grid: (rows, columns,
    the tile's fields, its halo-extended p from the zero-padded global p),
    the halo, and the whole grid's apply of that p."""
    F, triples = meta["F"], meta["triples"]
    H, W = int(F.shape[1]), int(F.shape[2])
    ah, aw = sharded_cg.halo_widths(triples)
    p = torch.as_tensor(np.random.RandomState(seed).randn(meta["ctot"], H, W).astype(f32))
    pad = tF.pad(p, (aw, aw, ah, ah))
    tiles = [((r0, r1), (c0, c1), F[:, r0:r1, c0:c1].contiguous(),
              pad[:, r0:r1 + 2 * ah, c0:c1 + 2 * aw].contiguous())
             for r0, r1 in split_bounds(H, 2) for c0, c1 in split_bounds(W, 2)]
    return tiles, (ah, aw), _stencil_apply(F.float(), triples, p)


SOURCE = Path(sharded_cg.__file__).parent / "csrc" / "tile_apply.cu"


def kernel_shape():
    """(TA_BLOCK, TA_ROWS): the kernel's threads a block along x and rows a
    thread, as its source defines them."""
    text = SOURCE.read_text()
    return tuple(int(re.search(rf"#define {name} (\d+)", text).group(1))
                 for name in ("TA_BLOCK", "TA_ROWS"))


def launch_grid(C, th, tw):
    """The C launch's grid: (column blocks, bands of TA_ROWS rows, C)."""
    block, rows = kernel_shape()
    return (-(-tw // block), -(-th // rows), C)


def launch_table(triples, C, th, tw, ah, aw):
    """The kernel's parameter as tile_apply_launch fills it: each triple's
    flat source place in p_ext and its field, and the channels' starts."""
    table, starts = sharded_cg._launch_table(tuple(triples), C)
    ew, eplane = tw + 2 * aw, (th + 2 * ah) * (tw + 2 * aw)
    rows = [tuple(table[4 * k:4 * k + 4]) for k in range(len(triples))]
    src = [j * eplane + (ah + dx) * ew + (aw + dy) for dx, dy, j, _f in rows]
    return src, [f for *_r, f in rows], list(starts)


def emulate(F, triples, p_ext, ah, aw):
    """The kernel's apply of one tile, thread by thread (a block's columns
    at once); also returns how many threads wrote each output."""
    C = int(p_ext.shape[0])
    th, tw = int(F.shape[1]), int(F.shape[2])
    ew, plane, eplane = tw + 2 * aw, th * tw, int(p_ext.shape[1]) * (tw + 2 * aw)
    block, rows = kernel_shape()
    gx, gy, gz = launch_grid(C, th, tw)
    src, fid, starts = launch_table(triples, C, th, tw, ah, aw)
    by_channel = sorted(triples, key=lambda t: t[1])
    Ff, pf = F.reshape(-1), p_ext.reshape(-1)
    out = torch.full((C * plane,), float("nan"))
    writes = torch.zeros(C * plane, dtype=torch.int32)
    for i in range(gz):
        for bx in range(gx):
            x = torch.arange(bx * block, min((bx + 1) * block, tw))  # threads past tw return
            for band in range(gy):
                y0 = band * rows
                for r in range(rows):
                    y = y0 + r
                    if y >= th:
                        continue
                    acc = torch.zeros(len(x))
                    for k in range(starts[i], starts[i + 1]):
                        fq = fid[k] * plane + y0 * tw + x + r * tw
                        sq = src[k] + y0 * ew + x + r * ew
                        (dx, dy), _i, j, _f = by_channel[k]
                        # the flat reads land where the stencil reads
                        assert bool((fq // plane == fid[k]).all())
                        assert bool((sq // eplane == j).all())
                        assert bool((sq % eplane // ew == ah + dx + y).all())
                        assert bool((sq % ew == aw + dy + x).all())
                        acc = acc + Ff[fq].float() * pf[sq]
                    q = i * plane + y * tw + x
                    out[q] = acc
                    writes[q] += 1
    return out.reshape(C, th, tw), writes.reshape(C, th, tw)


@pytest.mark.parametrize("case", list(CASES))
def test_model_equals_twin_and_whole_grid_apply(case):
    """The model of the kernel equals the plain twin and the whole grid's
    apply cropped to the tile, bitwise, on every tile of a 2x2 split, with
    every point written by exactly one block and nothing read beyond
    p_ext or the tile's fields (NaN there)."""
    meta = _meta(case)
    F, triples = meta["F"], meta["triples"]
    if case == "image_warping":
        assert (F.shape[0], len(triples)) == (26, 31)
    if case == "bf16":
        assert F.dtype == torch.bfloat16
    tiles, (ah, aw), whole = _tiles(meta)
    assert (ah, aw) == ((2, 2) if case == "radius2" else (1, 1))
    for (r0, r1), (c0, c1), Ft, pe in tiles:
        got, writes = emulate(Ft, triples, pe, ah, aw)
        assert bool((writes == 1).all())
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, sharded_cg.tile_apply_reference(Ft, triples, pe, ah, aw))
        assert torch.equal(got, whole[:, r0:r1, c0:c1])


@pytest.mark.parametrize("shape", [(250, 151), (250, 150), (256, 256), (17, 5)])
def test_model_on_ragged_tiles(shape):
    """A 500 x 301 grid splits 2 x 2 into tiles of 250 x 151 and 250 x 150:
    the last block of columns is ragged (a 17 x 5 tile is narrower than
    one block and has an odd number of rows, so its last band holds one).
    Random fields and p through poisson's triples, float32 and bfloat16:
    bitwise the twin, every point written once."""
    triples = _meta("poisson")["triples"]
    th, tw = shape
    rng = np.random.RandomState(th + tw)
    F = torch.as_tensor(rng.randn(5, th, tw).astype(f32))
    pe = torch.as_tensor(rng.randn(4, th + 2, tw + 2).astype(f32))
    for Ff in (F, F.to(torch.bfloat16)):
        got, writes = emulate(Ff, triples, pe, 1, 1)
        assert bool((writes == 1).all()) and bool(torch.isfinite(got).all())
        assert torch.equal(got, sharded_cg.tile_apply_reference(Ff, triples, pe, 1, 1))


@pytest.mark.parametrize("case", ["poisson", "image_warping", "radius2", "bf16"])
def test_model_matches_the_pallas_tile_kernel(case):
    """The model against the JAX package's _tile_apply_kernel (pallas_cg.py
    :1167) in interpret mode on the first tile, to 1e-6 of the output's
    largest magnitude: XLA on the CPU may contract a product and a sum into
    one fused multiply-add, which the kernel never does."""
    meta = _meta(case)
    tiles, (ah, aw), _whole = _tiles(meta)
    _r, _c, Ft, pe = tiles[0]
    got = emulate(Ft, meta["triples"], pe, ah, aw)[0].numpy()
    C, th, tw = int(pe.shape[0]), int(Ft.shape[1]), int(Ft.shape[2])
    Fj = jnp.asarray(Ft.float().numpy())
    if Ft.dtype == torch.bfloat16:
        Fj = Fj.astype(jnp.bfloat16)
    kernel = functools.partial(_tile_apply_kernel, triples=tuple(meta["triples"]),
                               n_channels=C, ah=ah, aw=aw)
    want = np.asarray(pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((C, th, tw),
                                                                            jnp.float32),
                                     interpret=True)(Fj, jnp.asarray(pe.numpy())))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("C, th, tw, grid", [
    # poisson 512x512x4 on 2x2 ranks: 1 x 128 x 4 blocks of 256 threads
    (4, 256, 256, (1, 128, 4)),
    # image_warping 512x512x3 on 2x2 ranks
    (3, 256, 256, (1, 128, 3)),
    # image_warping 500x301x3's ragged tiles
    (3, 250, 151, (1, 125, 3)),
    (3, 250, 150, (1, 125, 3)),
    (1, 17, 5, (1, 9, 1)),
    (4, 1024, 1024, (4, 512, 4)),
    (64, 33, 257, (2, 17, 64)),
])
def test_launch_grid(C, th, tw, grid):
    """The grid the launch makes at the kernel's block and rows a thread
    (256 and 2): a point's output written by one thread, the grid's bands
    within CUDA's 65,535 (the launch refuses beyond)."""
    assert kernel_shape() == (256, 2)
    assert launch_grid(C, th, tw) == grid
    assert grid[1] <= 65535


@pytest.mark.parametrize("case", ["poisson", "image_warping", "radius2", "bf16"])
def test_launch_table_sorts_by_channel(case):
    """_launch_table's host arrays: the triples as rows (dx, dy, j, fid)
    sorted stably by output channel, and each channel's row starts; the
    fields fit the kernel parameter's 16 bits."""
    meta = _meta(case)
    triples = meta["triples"]
    C = int(meta["ctot"])
    table, starts = sharded_cg._launch_table(tuple(triples), C)
    rows = [tuple(table[4 * k:4 * k + 4]) for k in range(len(triples))]
    want = [(d[0], d[1], j, f) for d, _i, j, f in sorted(triples, key=lambda t: t[1])]
    assert rows == want
    assert list(starts) == [sum(1 for t in triples if t[1] < c) for c in range(C + 1)]
    assert max(f for *_r, f in rows) <= 0xffff
    assert sharded_cg._launch_table(tuple(triples), C) is sharded_cg._launch_table(
        tuple(triples), C)  # cached: the same arrays every iteration
