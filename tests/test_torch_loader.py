"""The port's OBJ/MTL/BMP loading (`models/loader.py`, `utils/bmp.py`,
`utils/content.py`, the native tokenizer `native/native_loader.py`)
against the JAX package's, on models written from numpy into a temporary
directory: triangles with ``v/vt/vn``, a quad and negative indices, faces
without ``vn`` (computed normals), ``v//n`` corners, faces before any
``usemtl``, a material used twice, and ``map_Kd`` BMPs in 8, 24 and 32
bits in both row orders.

Every check is exact: parsing, unifying and filling the scene are host
numpy code in both packages, in the same operation order.
"""

import os
import zipfile

import numpy as np
import pytest

import torch_parity  # noqa: F401  (the import guard)

from raytracercuda_tpu import AccelKind as JaxAccelKind
from raytracercuda_tpu import RenderConfig as JaxRenderConfig
from raytracercuda_tpu import Scene as JaxScene
from raytracercuda_tpu.models import loader as jloader
from raytracercuda_tpu.utils.bmp import read_bmp as jax_read_bmp

import raytracercuda_torch as trt
from raytracercuda_torch.models import loader as tloader
from raytracercuda_torch.native import native_loader as tnative
from raytracercuda_torch.utils import content as tcontent
from raytracercuda_torch.utils.bmp import read_bmp

from chip_smoke import write_bmp, write_textured_obj


def _texels(h, w, seed, colours=None):
    rng = np.random.default_rng(seed)
    if colours is None:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    pal = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    return pal[rng.integers(0, colours, (h, w))]


def model_textured(d):
    return write_textured_obj(str(d), faces=300, tex_size=16, seed=3)


def model_quad(d):
    path = os.path.join(d, "quad.obj")
    with open(path, "w") as f:
        f.write("# a quad by negative indices, then a triangle\n"
                "v 0 0 0\nv 1 0 0\nv 1 1 0.5\nv 0 1 0\nv 2 0.5 1\n"
                "f -5 -4 -3 -2\n"
                "f 2 5 3\n")
    return path


def model_materials(d):
    """Faces before any usemtl, three materials (one used twice), 8-bit
    bottom-up and 32-bit top-down textures, no vn but one v//n face."""
    write_bmp(os.path.join(d, "a8.bmp"), _texels(6, 10, 1, colours=40), bpp=8)
    write_bmp(os.path.join(d, "b32.bmp"), _texels(9, 5, 2), bpp=32,
              top_down=True)
    with open(os.path.join(d, "mats.mtl"), "w") as f:
        f.write("# materials\nnewmtl matA\nKd 0.9 0.5 0.25\nmap_Kd a8.bmp\n"
                "newmtl matB\nKd 0.1 0.2 0.3\nmap_Kd b32.bmp\n"
                "newmtl matC\nKd 0.5 0.5 0.5\n")
    rng = np.random.default_rng(5)
    v = rng.normal(size=(12, 3)).astype(np.float32)
    vt = rng.random((12, 2)).astype(np.float32)
    lines = ["mtllib mats.mtl"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in v]
    lines += [f"vt {a:.9g} {b:.9g}" for a, b in vt]
    lines += ["vn 0 0 1",
              "f 1/1 2/2 3/3",
              "usemtl matA", "f 2/2 3/3 4/4 5/5",
              "usemtl matB", "f 4/4 6/6 7/7", "f -1/-1 -2/-2 -3/-3",
              "usemtl matC", "f 8//1 9//1 10//1",
              "usemtl matA", "f 10/10 11/11 12/12"]
    path = os.path.join(d, "mats.obj")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


MODELS = {"textured": model_textured, "quad": model_quad,
          "materials": model_materials}


def python_parse(path):
    """The port's Python parser, whatever the native route would do."""
    real = tnative.parse_obj
    tnative.parse_obj = lambda p: None
    try:
        return tloader.parse_obj(path)
    finally:
        tnative.parse_obj = real


def assert_same_obj(a, b):
    np.testing.assert_array_equal(a.positions, b.positions)
    for name in ("normals", "uvs"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert [m for m, _ in a.groups] == [m for m, _ in b.groups]
    for (_, fa), (_, fb) in zip(a.groups, b.groups):
        np.testing.assert_array_equal(fa, fb)
    assert a.materials == b.materials
    assert a.mtl_files == b.mtl_files


@pytest.mark.parametrize("model", sorted(MODELS))
def test_parse_matches_jax(model, tmp_path):
    path = MODELS[model](tmp_path)
    assert_same_obj(tloader.parse_obj(path), jloader.parse_obj(path))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_native_and_python_routes_agree(model, tmp_path):
    path = MODELS[model](tmp_path)
    assert tnative._load() is not None, "the OBJ tokenizer did not build"
    before = dict(tloader.parse_routes)
    native = tloader.parse_obj(path)
    python = python_parse(path)
    assert tloader.parse_routes["native"] == before["native"] + 1
    assert tloader.parse_routes["python"] == before["python"] + 1
    assert_same_obj(native, python)


def test_tokenizer_builds_in_the_port():
    lib = tnative.library_path()
    assert lib.parent.name == "_build"
    assert lib.parent.parent.name == "raytracercuda_torch"
    assert tnative.SOURCE.name == "obj_loader.cpp"
    assert tnative.SOURCE.parent.name == "csrc"


@pytest.mark.parametrize("model", sorted(MODELS))
def test_scene_data_matches_jax(model, tmp_path):
    path = MODELS[model](tmp_path)
    ts = trt.Scene.create(trt.RenderConfig(accel=trt.AccelKind.BRUTE), "cpu")
    js = JaxScene.create(JaxRenderConfig(accel=JaxAccelKind.BRUTE))
    assert tloader.load_model(path, ts) and jloader.load_model(path, js)
    assert len(ts.meshes) == len(js.meshes)
    assert [m.material_id for m in ts.meshes] == \
        [m.material_id for m in js.meshes]
    got, want = ts.data(), js.data()
    for k in ("positions", "faces", "mesh_material", "albedo", "texture_id",
              "textures", "reflectivity"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert sorted(got.attrs) == sorted(want.attrs)
    for s in want.attrs:  # normals, uvs, tangents, bitangents
        np.testing.assert_array_equal(got.attrs[s].numpy(),
                                      np.asarray(want.attrs[s]),
                                      err_msg=f"slot {s}")
    if model == "materials":
        # The scene's default material, then the faces before any usemtl
        # (material ""), matA, matB and matC (matA once).
        assert len(ts.materials) == 5 and len(ts.textures) == 2
        assert [m.texture_id for m in ts.materials] == [-1, -1, 0, 1, -1]


def test_error_codes_match_jax(tmp_path):
    empty = tmp_path / "empty.obj"
    empty.write_text("# nothing\n")
    points = tmp_path / "points.obj"
    points.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\n")
    cases = [str(tmp_path / "missing.obj"), str(empty), str(points)]
    got = [tloader.load_model_err(p, trt.Scene.create(
        trt.RenderConfig(accel=trt.AccelKind.BRUTE), "cpu")) for p in cases]
    want = [jloader.load_model_err(p, JaxScene.create(JaxRenderConfig(
        accel=JaxAccelKind.BRUTE))) for p in cases]
    assert got == want == [trt.ERROR_INVALID_PARAMETER, 1, 1]
    assert not tloader.load_model(cases[0], trt.Scene.create(
        trt.RenderConfig(accel=trt.AccelKind.BRUTE), "cpu"))


def test_compute_normals_and_tangents_match_jax():
    rng = np.random.default_rng(8)
    pos = rng.normal(size=(30, 3)).astype(np.float32)
    uv = rng.random((30, 2)).astype(np.float32)
    idx = rng.integers(0, 30, (40, 3)).astype(np.uint32)
    n = tloader.compute_normals(pos, idx)
    np.testing.assert_array_equal(n, jloader.compute_normals(pos, idx))
    for a, b in zip(tloader.compute_tangents(pos, n, uv, idx),
                    jloader.compute_tangents(pos, n, uv, idx)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("bpp", [8, 24, 32])
def test_read_bmp_matches_jax(bpp, top_down, tmp_path):
    # 7 and 5 columns: rows need padding to 4 bytes at every depth.
    rgb = _texels(6, 7 if bpp != 32 else 5, bpp,
                  colours=50 if bpp == 8 else None)
    path = str(tmp_path / "t.bmp")
    write_bmp(path, rgb, bpp=bpp, top_down=top_down)
    got = read_bmp(path)
    np.testing.assert_array_equal(got, jax_read_bmp(path))
    np.testing.assert_array_equal(got, rgb.astype(np.float32) / 255.0)


def test_read_bmp_rejects(tmp_path):
    bad = tmp_path / "bad.bmp"
    bad.write_bytes(b"PNG not a bitmap")
    with pytest.raises(ValueError, match="not a BMP"):
        read_bmp(str(bad))


def test_content_find(tmp_path, monkeypatch):
    (tmp_path / "suzanne.obj").write_text("v 0 0 0\n")
    with zipfile.ZipFile(tmp_path / "bunny.zip", "w") as zf:
        zf.writestr("bunny/bunny.obj", "v 0 0 0\n")
    monkeypatch.setattr(tcontent, "CONTENT_DIRS", ["", str(tmp_path)])
    monkeypatch.setattr(tcontent, "_CACHE", str(tmp_path / "cache"))
    assert tcontent.content_dir() == str(tmp_path)
    assert tcontent.find("suzanne.obj") == str(tmp_path / "suzanne.obj")
    found = tcontent.find("bunny.obj")  # extracted, found nested
    assert found is not None and found.endswith("bunny.obj")
    assert tcontent.find("f16.obj") is None
    monkeypatch.setattr(tcontent, "CONTENT_DIRS", [""])
    assert tcontent.find("suzanne.obj") is None
