"""The port's cluster builders against the JAX package's, on the CPU.

- ``accel.build_cluster_bvh``: every builder (``sah``, ``sah_free``,
  ``sah_chunk``, ``median``, ``morton``, ``ploc``), the SBVH pre-split at
  0.3, and ``sah_rays`` on a seeded (M, 8) ray table, over plane_sphere's and
  coatball's flattened triangles: ``order``, node boxes and ``BVHSpec``
  (``partial_clusters`` included) equal the JAX build's bit for bit (the
  port keeps its own numpy copy of the builders);
- (``tests/test_torch_builder_scenes.py`` holds whole scene builds and
  ``tests/test_torch_builder_images.py`` each builder's image against the
  JAX package's.)
"""

import numpy as np
import pytest

from metal_raytracing_tpu import accel as jaccel
from metal_raytracing_tpu_torch import accel as taccel
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import few_torch_threads  # noqa: F401
from torch_port_common import BUILDS, sample_ray_table, triangles

SIZE = 32
SCENES = ("plane_sphere", "coatball")


def assert_same_build(got, ref):
    for a, b, name in zip(got[:3], ref[:3], ("order", "node_lo", "node_hi")):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert repr(got[3]) == repr(ref[3])


@pytest.mark.parametrize("label", sorted(BUILDS))
def test_builder_equals_reference(label):
    for scene in SCENES:
        tris = triangles(scene, SIZE)
        kw = dict(cluster_size=384, **BUILDS[label])
        got = taccel.build_cluster_bvh(*tris, **kw)
        assert_same_build(got, jaccel.build_cluster_bvh(*tris, **kw))
        order, spec = got[0], got[3]
        real = order[order >= 0]
        if label == "presplit":  # references repeat their source triangles
            assert set(real.tolist()) == set(range(spec.num_triangles))
        else:
            assert sorted(real.tolist()) == list(range(spec.num_triangles))


def test_sah_rays_equals_reference():
    for scene in SCENES:
        tris = triangles(scene, SIZE)
        rays = sample_ray_table(triangles(scene, SIZE)[0])
        kw = dict(cluster_size=128, builder="sah_rays", rays=rays)
        got = taccel.build_cluster_bvh(*tris, **kw)
        assert_same_build(got, jaccel.build_cluster_bvh(*tris, **kw))
        # no sample, or one with no live ray: sah_free's build
        free = taccel.build_cluster_bvh(*tris, cluster_size=128)
        rays[:, 7] = 0.0
        for sample in (None, rays):
            assert_same_build(taccel.build_cluster_bvh(
                *tris, cluster_size=128, builder="sah_rays", rays=sample),
                free)


def test_unknown_builder_raises():
    tris = triangles("plane_sphere", SIZE)
    with pytest.raises(ValueError, match="builder"):
        taccel.build_cluster_bvh(*tris, builder="octree")
    with pytest.raises(ValueError, match="bvh_builder"):
        RenderConfig(bvh_builder="octree")
