"""Whole scene builds of the port's cluster builders against the JAX
package's, on the CPU: ``build_scene_data`` with ``ploc``, ``sah_rays`` on
a seeded ray table, the SBVH-style pre-split and the ``max_edge_frac``
subdivision equals the JAX build table for table, bit for bit, and the JAX
build carried across by ``scene_data_from_reference`` holds every table.
"""

import numpy as np
import pytest

from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.scene import build_scene_data as jbuild
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu_torch.io import procedural as tproc
from metal_raytracing_tpu_torch.scene import (build_scene_data,
                                              scene_data_arrays,
                                              scene_data_from_reference)
from metal_raytracing_tpu_torch.scenes import library as tlib
from torch_port_common import few_torch_threads  # noqa: F401
from torch_port_common import jax_scene_arrays, sample_ray_table, triangles

SIZE = 32


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


SCENE_BUILDS = {  # label -> (scene, Scene.build / build_scene_data keywords)
    "coatball-ploc": ("coatball", dict(builder="ploc")),
    "coatball-sah_rays": ("coatball", dict(builder="sah_rays")),
    "coatball-presplit": ("coatball", dict(presplit=0.3)),
    "plane_sphere-max_edge_frac": ("plane_sphere", dict(max_edge_frac=0.1)),
}


@pytest.mark.parametrize("label", sorted(SCENE_BUILDS))
def test_scene_tables_equal_reference(label):
    """Every table of ``build_scene_data`` equals the JAX build's: the
    pre-split's repeated source triangles (``tri_src``), the subdivision's
    new triangles, the partly full clusters' counts."""
    scene, kw = SCENE_BUILDS[label]
    if kw.get("builder") == "sah_rays":
        kw = dict(kw, rays=sample_ray_table(triangles(scene, SIZE)[0]))
    js = jlib.get_scene(scene, SIZE, SIZE)
    ts = tlib.get_scene(scene, SIZE, SIZE)
    jdata, jspec = jaccel_scene(js, kw)
    tdata, tspec = build_scene_data(ts.instances, ts.lights, ts.camera(),
                                    device="cpu", **kw)
    assert repr(tspec.bvh) == repr(jspec.bvh)
    ja, ta = jax_scene_arrays(jdata), scene_data_arrays(tdata)
    assert sorted(ja) == sorted(ta)
    for key, arr in ja.items():
        assert ta[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(ta[key], arr, err_msg=key)
    # the JAX build carried across (scene_data_from_reference)
    cdata, cspec = scene_data_from_reference(ja, jspec, "cpu")
    assert repr(cspec.bvh) == repr(jspec.bvh)
    for key, arr in scene_data_arrays(cdata).items():
        np.testing.assert_array_equal(arr, ja[key], err_msg=key)
    if "presplit" in kw:
        src = ta["tri_src"][ta["tri_src"] >= 0]
        assert len(src) > len(set(src.tolist()))  # duplicated references
    if "max_edge_frac" in kw:
        assert tspec.bvh.num_triangles > ts.triangle_count


def jaccel_scene(scene, kw):
    """The JAX package's ``build_scene_data`` at the port's defaults."""
    return jbuild(scene.instances, scene.lights, scene.camera(),
                  cluster_size=384, builder=kw.get("builder", "sah_free"),
                  **{k: v for k, v in kw.items() if k != "builder"})
