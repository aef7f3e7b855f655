"""The port's scene build against the JAX package's on the CPU: the
cluster boxes, triangle planes and shade rows, the JAX tables carried to
the port (``scene_data_from_reference``) and back, and the builders and
features that raise (one build of each scene by each package at the
renderer's defaults, ``torch_port_common.scene_tables``)."""

import numpy as np
import pytest
import torch

from metal_raytracing_tpu_torch import accel as taccel
from metal_raytracing_tpu_torch.scene import (build_scene_data,
                                              scene_data_arrays,
                                              scene_data_from_reference)
from metal_raytracing_tpu_torch.scenes import library as tlib
from torch_port_common import (few_torch_threads,  # noqa: F401
                               procedural_models, scene_tables)

SCENES = ["coatball", "teapot"]


@pytest.mark.parametrize("scene", SCENES)
def test_plane_tables_close(scene):
    """Cluster boxes, triangle planes and shade rows: the same math.  The
    port emulates the fused multiply-adds of the JAX package's jitted build,
    so the tables agree to the bit here; the gate allows for the rounding of
    other builds."""
    ja, _, ta, _ = scene_tables(scene)
    for key in ("clu_planes", "tri_planes", "shade_table"):
        assert ta[key].shape == ja[key].shape, key
        np.testing.assert_allclose(ta[key], ja[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("scene", SCENES)
def test_scene_data_from_reference_round_trips(scene):
    ja, jspec, _, _ = scene_tables(scene)
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
