"""The port's IO module (opt_tpu_torch/utils/io.py, a numpy copy) held to
the JAX package's (opt_tpu/utils/io.py) on files written to tmp_path: every
reader's output equals the reference's, and the mesh helpers agree on a
tetrahedron and a 6x6 grid mesh."""

import struct

import numpy as np
import pytest

from opt_tpu.utils import io as jio
from opt_tpu_torch.utils import io as tio

TET_V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
TET_F = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]], np.int32)


def grid_faces(n=6):
    """A 6x6 grid mesh: n^2 vertices on the unit square, two triangles a
    cell."""
    ij = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1).reshape(-1, 2)
    verts = np.concatenate([ij / (n - 1.0), np.zeros((n * n, 1))], 1).astype(np.float32)
    vid = np.arange(n * n).reshape(n, n)
    a, b, c, d = vid[:-1, :-1], vid[1:, :-1], vid[:-1, 1:], vid[1:, 1:]
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([b, d, c], -1).reshape(-1, 3)]).astype(np.int32)
    return verts, faces


MESHES = {"tetrahedron": (TET_V, TET_F), "grid6": grid_faces()}


def same(a, b):
    """Equal arrays, dtypes and shapes, or equal tuples of them."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def write_binary_ply(path, verts, faces):
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\nproperty float x\nproperty float y\n"
              "property float z\nproperty uchar flag\n"
              f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
              "element edge 1\nproperty int a\nproperty int b\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        for v in verts:
            f.write(struct.pack("<fffB", *v, 7))
        for fc in faces:
            f.write(struct.pack("<B", len(fc)) + struct.pack(f"<{len(fc)}i", *fc))
        f.write(struct.pack("<ii", 0, 1))


def write_obj(path, verts, faces):
    with open(path, "w") as f:
        f.write("# a comment\n\n")
        for v in verts:
            f.write("v %g %g %g\n" % tuple(v))
        for fc in faces:
            f.write("f " + " ".join(f"{i + 1}/{i + 1}" for i in fc) + "\n")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_readers_equal_the_reference(tmp_path, mesh):
    """PLY ascii (save_mesh), PLY binary, OFF (save_mesh) and OBJ, through
    each reader and load_mesh."""
    verts, faces = MESHES[mesh]
    files = {"ascii.ply": None, "mesh.off": None, "binary.ply": write_binary_ply,
             "mesh.obj": write_obj}
    for name, writer in files.items():
        p = str(tmp_path / name)
        if writer is None:
            jio.save_mesh(p, verts, faces)
            with open(p) as f:
                jtext = f.read()
            tio.save_mesh(p, verts, faces)
            with open(p) as f:
                assert f.read() == jtext
        else:
            writer(p, verts, faces)
        same(tio.load_mesh(p), jio.load_mesh(p))
        reader = {"ply": "load_ply", "off": "load_off", "obj": "load_obj"}[name.split(".")[-1]]
        same(getattr(tio, reader)(p), getattr(jio, reader)(p))
        np.testing.assert_array_equal(tio.load_mesh(p)[1], faces)
    with pytest.raises(ValueError, match="unsupported mesh format"):
        tio.load_mesh(str(tmp_path / "mesh.stl"))


def test_vertex_only_mesh_files(tmp_path):
    """save_mesh without faces, as the reference apps write point sets."""
    p = str(tmp_path / "points.ply")
    tio.save_mesh(p, TET_V)
    same(tio.load_ply(p), jio.load_ply(p))
    assert len(tio.load_ply(p)[1]) == 0


@pytest.mark.parametrize("shape", [(7, 5, 2), (6, 4)])
def test_imagedump_equals_the_reference(tmp_path, shape):
    a = np.random.RandomState(0).rand(*shape).astype(np.float32)
    p, q = str(tmp_path / "t.imagedump"), str(tmp_path / "j.imagedump")
    tio.save_imagedump(p, a)
    jio.save_imagedump(q, a)
    assert open(p, "rb").read() == open(q, "rb").read()
    same(tio.load_imagedump(p), jio.load_imagedump(p))
    np.testing.assert_array_equal(tio.load_imagedump(p), a)
    # the uchar form (type 1) and a refused type
    r = str(tmp_path / "u8.imagedump")
    with open(r, "wb") as f:
        f.write(struct.pack("<iiii", 3, 2, 1, 1) + bytes(range(6)))
    same(tio.load_imagedump(r), jio.load_imagedump(r))
    with open(r, "wb") as f:
        f.write(struct.pack("<iiii", 3, 2, 1, 5))
    with pytest.raises(ValueError, match="unsupported"):
        tio.load_imagedump(r)


def test_images_equal_the_reference(tmp_path):
    """PNG through PIL, imported only inside load_image/save_image."""
    a = np.random.RandomState(1).rand(5, 4, 3).astype(np.float32)
    p = str(tmp_path / "a.png")
    tio.save_image(p, a)
    same(tio.load_image(p), jio.load_image(p))
    g = str(tmp_path / "g.png")
    tio.save_image(g, a[..., :1])
    same(tio.load_image(g), jio.load_image(g))


def test_constraint_and_marker_files_equal_the_reference(tmp_path):
    con = tmp_path / "cat.constraints"
    con.write_text("3\n1 2 3.5 4\n10 11 12 13.25\n0 0 1 1\n")
    same(tio.load_constraints(str(con)), jio.load_constraints(str(con)))
    mrk = tmp_path / "handles.mrk"
    mrk.write_text("0.1 0.2 0.3 5\n\n1 2 3 0 17\nshort line\n")
    same(tio.load_mrk(str(mrk)), jio.load_mrk(str(mrk)))
    np.testing.assert_allclose(tio.load_mrk(str(mrk)), [[0.1, 0.2, 0.3, 5], [1, 2, 3, 17]])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_helpers_equal_the_reference(mesh):
    """mesh_edges, csr_from_edges and sqrt3_subdivide (closed tetrahedron:
    8 vertices, 12 faces; the grid's boundary edges keep their face)."""
    verts, faces = MESHES[mesh]
    e = tio.mesh_edges(faces)
    same(e, jio.mesh_edges(faces))
    same(tio.csr_from_edges(*e, len(verts)), jio.csr_from_edges(*e, len(verts)))
    rp, ci = tio.csr_from_edges(*e, len(verts))
    assert rp[-1] == len(e[0]) and np.array_equal(ci, e[1])
    sub = tio.sqrt3_subdivide(verts, faces)
    same(sub, jio.sqrt3_subdivide(verts, faces))
    assert len(sub[0]) == len(verts) + len(faces)
    if mesh == "tetrahedron":
        assert len(sub[1]) == 12
