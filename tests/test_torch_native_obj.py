"""The port's native OBJ parser (``metal_raytracing_tpu_torch/io/native.py``
over its copy of ``native/objparse.cpp``) and ``load_obj``'s dispatch,
against the JAX package's two parsers, bit for bit, on the CPU.

Each parser is held against its counterpart: the port's native parse
against the JAX package's native parse, the port's Python parse against
the JAX package's Python parse, and, where no decimal string sits at a
float32 rounding tie, the two parsers of the port against each other."""

import dataclasses
import os

import numpy as np
import pytest

from metal_raytracing_tpu import assets as jassets
from metal_raytracing_tpu.io import native as jnative
from metal_raytracing_tpu.io import obj as jobj
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu_torch import assets as tassets
from metal_raytracing_tpu_torch.io import native as tnative
from metal_raytracing_tpu_torch.io import obj as tobj
from metal_raytracing_tpu_torch.io import procedural as tproc
from metal_raytracing_tpu_torch.scene import scene_data_arrays
from metal_raytracing_tpu_torch.scenes import library as tlib

# 1 + 2^-24 (a float32 tie) + about 9e-37, written out: rounded to float32
# at once (sscanf("%f")) it is 1 + 2^-23; through float64 (float(), then
# np.float32) it is 1.0
DOUBLE_ROUNDING = ("1.0000000596046447753906250000000000008673617379884035472"
                   "0596224069595336914062")


def assert_models_equal(a, b):
    """Every field of two LoadedModels (either package's) bit for bit."""
    assert a.name == b.name and a.face_count == b.face_count
    for field in ("positions", "normals", "texcoords"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)
    assert len(a.submeshes) == len(b.submeshes)
    for sa, sb in zip(a.submeshes, b.submeshes):
        assert sa.material_name == sb.material_name
        assert dataclasses.astuple(sa.material) == dataclasses.astuple(
            sb.material)
        for field in ("tri_pos_idx", "tri_norm_idx", "tri_uv_idx"):
            x, y = getattr(sa, field), getattr(sb, field)
            assert (x is None) == (y is None), (sa.material_name, field)
            if x is not None:
                assert x.dtype == y.dtype, field
                np.testing.assert_array_equal(x, y, err_msg=field)


def synthetic_obj(path, seed: int, with_vn: bool) -> None:
    """A seeded OBJ file: every face form (``i``, ``i/j``, ``i//k``,
    ``i/j/k``) with 1-based and negative indices, triangles, quads and
    6-gons, tabs, CRLF, comments and blank lines, partial ``vt``, two
    ``usemtl`` with an ``mtllib`` and an empty submesh; with ``with_vn``
    faces with and without ``vn``, without it no ``vn`` at all."""
    rng = np.random.default_rng(seed)
    nv, nt, nn = 60, 25, 12 if with_vn else 0
    eol = "\r\n" if seed % 2 else "\n"

    def sep():
        return str(rng.choice([" ", "\t", "  ", " \t"]))

    def num(x):
        return str(rng.choice(["%.9g", "%.6f", "%.3e", "%g"])) % x

    lines = ["# synthetic OBJ", "", f"mtllib{sep()}t{seed}.mtl"]
    for p in rng.normal(size=(nv, 3)).astype(np.float32) * 10:
        lines.append("v" + sep() + sep().join(num(x) for x in p))
    lines.append("# texcoords for some faces only")
    for t in rng.uniform(size=(nt, 2)).astype(np.float32):
        lines.append("vt" + sep() + sep().join(num(x) for x in t))
    for n in rng.normal(size=(nn, 3)).astype(np.float32):
        lines.append("vn" + sep() + sep().join(num(x) for x in n))

    def idx(i, count):  # 1-based, or negative for about a third of them
        return str(i + 1 if rng.uniform() < 0.6 else i - count)

    forms = ["i", "i/j"] + (["i//k", "i/j/k"] if with_vn else [])

    def face(form):
        k = int(rng.choice([3, 3, 4, 6]))
        corners = []
        for v in rng.choice(nv, size=k, replace=False):
            c = idx(v, nv)
            if form in ("i/j", "i/j/k"):
                c += "/" + idx(rng.integers(nt), nt)
            if form == "i//k":
                c += "//" + idx(rng.integers(nn), nn)
            elif form == "i/j/k":
                c += "/" + idx(rng.integers(nn), nn)
            corners.append(c)
        return "f" + sep() + sep().join(corners)

    # faces before any usemtl: the "" submesh, every form mixed
    lines += [face(str(rng.choice(forms))) for _ in range(6)]
    lines += [f"usemtl{sep()}red", "# all texcoords: uv kept"]
    lines += [face("i/j/k" if with_vn else "i/j") for _ in range(8)]
    lines += ["usemtl empty", f"usemtl{sep()}blue"]  # "empty" gets no face
    lines += [face(str(rng.choice(forms))) for _ in range(10)]
    lines += ["usemtl red"]  # back to an earlier submesh
    lines += [face(forms[-1]) for _ in range(4)]
    lines += ["usemtl missing"]  # a material the MTL does not define
    lines += [face(forms[0]) for _ in range(3)]
    with open(path, "w", newline="") as f:
        f.write(eol.join(lines) + eol)
    with open(os.path.join(os.path.dirname(path), f"t{seed}.mtl"), "w") as f:
        f.write("newmtl red\nKd 0.8 0.1 0.1\nNs 12\n"
                "newmtl blue\nKd 0.1 0.1 0.9\nKs 0.5 0.5 0.5\nd 0.5\n"
                "newmtl empty\nKd 0 1 0\n")


def both_libraries():
    """Build both packages' native libraries: no test here skips for want
    of a compiler."""
    assert jnative.load_library() is not None
    tnative.load_library()


@pytest.mark.parametrize("seed,with_vn", [(3, True), (8, False)])
def test_synthetic_obj_four_parsers(tmp_path, seed, with_vn):
    both_libraries()
    path = str(tmp_path / f"t{seed}.obj")
    synthetic_obj(path, seed, with_vn)
    for compute_normals in (True, False):
        port_native = tobj.load_obj(path, compute_normals, use_native=True)
        port_python = tobj.load_obj(path, compute_normals, use_native=False)
        assert_models_equal(port_native, jobj.load_obj(
            path, compute_normals, use_native=True))
        assert_models_equal(port_python, jobj._load_obj_python(
            path, compute_normals))
        assert_models_equal(port_native, port_python)
    m = port_native
    names = [s.material_name for s in m.submeshes]
    assert names == ["", "red", "blue", "missing"]  # "empty" skipped
    assert m.submeshes[1].tri_uv_idx is not None  # every corner has a vt
    assert m.submeshes[0].tri_uv_idx is None  # partial vt
    assert m.submeshes[2].material.dissolve == 0.5
    assert m.submeshes[3].material.name == "default"
    assert m.face_count == 31 and m.triangle_count > m.face_count
    if with_vn:
        # faces without vn index synthesized normals after the file's 12
        assert m.normals.shape == (12 + 60, 3)
        assert (m.submeshes[0].tri_norm_idx >= 12).any()
    else:
        assert m.normals.shape == (60, 3)
        np.testing.assert_array_equal(m.submeshes[2].tri_norm_idx,
                                      m.submeshes[2].tri_pos_idx)


def test_double_rounding_each_parser_like_its_counterpart(tmp_path):
    """The parsers disagree on a decimal string near a float32 tie; each
    port parser keeps its JAX counterpart's rounding."""
    both_libraries()
    path = str(tmp_path / "tie.obj")
    with open(path, "w") as f:
        f.write(f"v {DOUBLE_ROUNDING} 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\n")

    def bits(model):
        return int(model.positions.view(np.uint32)[0, 0])

    assert bits(tobj.load_obj(path)) == 0x3F800001
    assert bits(jobj.load_obj(path, use_native=True)) == 0x3F800001
    assert bits(tobj.load_obj(path, use_native=False)) == 0x3F800000
    assert bits(jobj._load_obj_python(path)) == 0x3F800000


def test_procedural_dragon_native_equals_python(tmp_path):
    """~100k triangles written from the port's procedural dragon: the two
    parsers of the port give the same model, which is the JAX native
    parser's and the procedural model itself."""
    both_libraries()
    model = tproc.make_model("dragon")
    path = str(tmp_path / "dragon.obj")
    tobj.write_obj(model, path)
    native = tobj.load_obj(path)
    assert native.triangle_count == model.triangle_count > 99_000
    assert_models_equal(native, tobj.load_obj(path, use_native=False))
    assert_models_equal(native, jobj.load_obj(path, use_native=True))
    assert_models_equal(native, model)


@pytest.fixture
def clear_model_caches():
    """``resolve_model`` is lru-cached in both packages: clear both around a
    test that moves ``MRT_RESOURCES``."""
    for assets in (tassets, jassets):
        assets.resolve_model.cache_clear()
    yield
    for assets in (tassets, jassets):
        assets.resolve_model.cache_clear()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_plane_sphere_tables_from_obj_files(tmp_path, monkeypatch,
                                            clear_model_caches, native):
    """plane_sphere built by both packages from OBJ files under
    ``MRT_RESOURCES``, every parse native (or, under ``MRT_NO_NATIVE``,
    Python) in both: the scene tables bit for bit."""
    both_libraries()
    for name in ("plane", "sphere"):
        tobj.write_obj(tproc.make_model(name), str(tmp_path / f"{name}.obj"))
    monkeypatch.setenv("MRT_RESOURCES", str(tmp_path))
    if native:
        monkeypatch.delenv("MRT_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("MRT_NO_NATIVE", "1")
    parsed = []
    for mod in (tnative, jnative):
        def spy(path, _parse=mod.parse_obj_native, _mod=mod):
            parsed.append((_mod.__name__, os.path.basename(path)))
            return _parse(path)
        monkeypatch.setattr(mod, "parse_obj_native", spy)
    jdata, jspec = jlib.get_scene("plane_sphere", 32, 32).build(
        cluster_size=384, builder="sah_free")
    tdata, tspec = tlib.get_scene("plane_sphere", 32, 32).build(
        cluster_size=384, builder="sah_free", device="cpu")
    expect = sorted((mod.__name__, f"{n}.obj") for mod in (tnative, jnative)
                    for n in ("plane", "sphere"))
    assert sorted(parsed) == (expect if native else [])
    assert tassets.find_obj("sphere") == str(tmp_path / "sphere.obj")
    assert repr(tspec.bvh) == repr(jspec.bvh)
    ja, ta = {}, scene_data_arrays(tdata)
    for name, value in jdata._asdict().items():
        if hasattr(value, "_asdict"):
            ja.update({f"{name}.{k}": np.asarray(v)
                       for k, v in value._asdict().items()})
        elif value is not None:
            ja[name] = np.asarray(value)
    assert sorted(ta) == sorted(ja)
    for key, arr in ja.items():
        assert ta[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(ta[key], arr, err_msg=key)


def test_failed_build_raises_and_python_still_parses(tmp_path, monkeypatch):
    """A compiler that cannot run, or that fails, raises RuntimeError with
    its output and the opt-out; nothing falls back to Python when native
    was asked for."""
    path = str(tmp_path / "tri.obj")
    with open(path, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    failing = tmp_path / "failing-cxx"
    failing.write_text("#!/bin/sh\necho 'objparse.cpp:1: error: no' >&2\n"
                       "exit 1\n")
    failing.chmod(0o755)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.delenv("MRT_NO_NATIVE", raising=False)
    for cxx, said in ((tmp_path / "no-such-compiler", "could not run"),
                      (failing, "error: no")):
        monkeypatch.setenv("CXX", str(cxx))
        for call in (tnative.load_library, lambda: tobj.load_obj(path),
                     lambda: tnative.parse_obj_native(path)):
            with pytest.raises(RuntimeError, match="MRT_NO_NATIVE") as err:
                call()
            assert said in str(err.value)
    assert tnative._lib is None
    assert tobj.load_obj(path, use_native=False).triangle_count == 1
    monkeypatch.setenv("MRT_NO_NATIVE", "1")
    assert tobj.load_obj(path).triangle_count == 1
    monkeypatch.undo()
    with pytest.raises(FileNotFoundError):
        tnative.parse_obj_native(str(tmp_path / "missing.obj"))
