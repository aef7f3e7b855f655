"""The port's scene build (BVH, packed planes, shade rows) against the JAX
package's, on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu_torch import accel as taccel
from metal_raytracing_tpu_torch.io import procedural as tproc
from metal_raytracing_tpu_torch.scene import (build_scene_data,
                                              scene_data_arrays,
                                              scene_data_from_reference)
from metal_raytracing_tpu_torch.scenes import library as tlib

SCENES = ["coatball", "teapot"]
W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The suite runs several test processes at once; two intra-op threads
    each keep torch from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def jax_scene_arrays(data) -> dict:
    """The JAX package's SceneData as numpy arrays, keyed as
    ``scene_data_arrays`` keys the port's."""
    out = {}
    for name, value in data._asdict().items():
        if value is None:
            continue
        if hasattr(value, "_asdict"):
            for sub, arr in value._asdict().items():
                out[f"{name}.{sub}"] = np.asarray(arr)
        else:
            out[name] = np.asarray(value)
    return out


@pytest.fixture(scope="module", autouse=True)
def procedural_models():
    """Both packages build their scenes from the procedural stand-ins."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jlib, "resolve_model", lambda n, prefer_file=True:
               jproc.make_model(n))
    mp.setattr(tlib, "resolve_model", lambda n, prefer_file=True:
               tproc.make_model(n))
    yield
    mp.undo()


_BUILDS = {}


def builds(scene):
    """(JAX arrays, JAX spec, port arrays, port spec) of one scene, built
    once per module at the renderer's defaults (sah_free, 384)."""
    if scene not in _BUILDS:
        jdata, jspec = jlib.get_scene(scene, W, H).build(
            cluster_size=384, builder="sah_free")
        tdata, tspec = tlib.get_scene(scene, W, H).build(
            cluster_size=384, builder="sah_free", device="cpu")
        _BUILDS[scene] = (jax_scene_arrays(jdata), jspec,
                          scene_data_arrays(tdata), tspec)
    return _BUILDS[scene]


@pytest.mark.parametrize("scene", SCENES)
def test_bvh_spec_identical(scene):
    _, jspec, _, tspec = builds(scene)
    assert repr(tspec.bvh) == repr(jspec.bvh)
    assert dataclasses.asdict(tspec.bvh) == dataclasses.asdict(jspec.bvh)
    assert (tspec.light_count, tspec.material_count, tspec.has_env_map) == (
        jspec.light_count, jspec.material_count, jspec.has_env_map)


@pytest.mark.parametrize("scene", SCENES)
def test_index_and_box_tables_exact(scene):
    ja, _, ta, _ = builds(scene)
    for key in ("tri_src", "geometry.material_id", "clu_counts", "node_lo",
                "node_hi", "sup_planes", "geometry.v0", "geometry.e1",
                "geometry.e2", "geometry.n0", "geometry.n1", "geometry.n2"):
        assert ta[key].dtype == ja[key].dtype, key
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)


@pytest.mark.parametrize("scene", SCENES)
def test_lights_materials_camera_exact(scene):
    ja, _, ta, _ = builds(scene)
    keys = [k for k in ja if k.split(".")[0] in
            ("lights", "materials", "camera")]
    assert sorted(keys) == sorted(k for k in ta if k.split(".")[0] in
                                  ("lights", "materials", "camera"))
    for key in keys:
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)


@pytest.mark.parametrize("scene", SCENES)
def test_plane_tables_close(scene):
    """Cluster boxes, triangle planes and shade rows: the same math.  The
    port emulates the fused multiply-adds of the JAX package's jitted build,
    so the tables agree to the bit here; the gate allows for the rounding of
    other builds."""
    ja, _, ta, _ = builds(scene)
    for key in ("clu_planes", "tri_planes", "shade_table"):
        assert ta[key].shape == ja[key].shape, key
        np.testing.assert_allclose(ta[key], ja[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("scene", SCENES)
def test_scene_data_from_reference_round_trips(scene):
    ja, jspec, _, _ = builds(scene)
    data, spec = scene_data_from_reference(ja, jspec, "cpu")
    assert repr(spec.bvh) == repr(jspec.bvh)
    assert isinstance(spec.bvh, taccel.BVHSpec)
    back = scene_data_arrays(data)
    assert sorted(back) == sorted(ja)
    for key, arr in ja.items():
        assert back[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    assert data.device == torch.device("cpu")


def test_unported_builders_and_features_raise():
    """Every builder and the subdivision are ported; what still raises is
    what the JAX package refuses too (tests/test_torch_builders.py holds
    each builder against the JAX build)."""
    scene = tlib.get_scene("teapot", 16, 16)
    with pytest.raises(ValueError, match="builder"):
        scene.build(builder="octree", device="cpu")
    data, spec = build_scene_data(scene.instances, scene.lights,
                                  scene.camera(), max_edge_frac=0.1,
                                  device="cpu")
    assert spec.bvh.num_triangles > scene.triangle_count
    # a textured scene is refused subdivision, as in the JAX package
    uv = tlib.get_scene("uv_test", 16, 16)
    with pytest.raises(ValueError, match="textured"):
        build_scene_data(uv.instances, uv.lights, uv.camera(),
                         max_edge_frac=0.1, device="cpu")
