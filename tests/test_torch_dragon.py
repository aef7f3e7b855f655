"""The port's slice on the dragon scene against the JAX package, on the CPU.

Dragon is the one ladder scene past 128 padded clusters (344 clusters, 43
supers of 8), so on the card it takes the hierarchical kernels K3/K4, and
with ``fused_broadphase=True`` the broad-phase kernel K5; here the port runs
their plain versions.  One JAX build of the scene (procedural stand-ins) is
carried to the port.  The JAX renderer at its default config (its exact BVH
tracer on the CPU, where ``fused_broadphase`` changes nothing) gives the
reference image; the port renders 1 spp at 32x24 at the default config and
with ``fused_broadphase=True``.  The gate is the reference's golden gate
(``tests/test_golden.py``): RMSE < 1e-3 and max pixel difference < 5e-2.

The reference is the JAX package's own path off a TPU (``tracer="bvh"``,
``compaction=True``), so the port's exact tracer on that path
(``tracer="bvh", compaction=True``: the plain packet walk, the
``dir_major`` and light-major sort keys) is held against the same image.
"""

import numpy as np
import pytest

from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.io.image import rmse
from metal_raytracing_tpu.renderer import Renderer as JRenderer
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.scene import scene_data_from_reference
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import few_torch_threads  # noqa: F401
from torch_port_common import jax_scene_arrays

W, H = 32, 24


@pytest.fixture(scope="module")
def reference():
    """(JAX renderer after 1 spp, port data, port spec)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jlib, "resolve_model", lambda n, prefer_file=True:
               jproc.make_model(n))
    try:
        jr = JRenderer(jlib.get_scene("dragon", W, H),
                       JConfig(width=W, height=H))
    finally:
        mp.undo()
    jr.render(1)
    tdata, tspec = scene_data_from_reference(jax_scene_arrays(jr.data),
                                             jr.spec, "cpu")
    return jr, tdata, tspec


def test_dragon_takes_the_hierarchical_kernels(reference):
    _, tdata, tspec = reference
    bvh = tspec.bvh
    assert (bvh.num_triangles, bvh.num_clusters, bvh.num_global) == (
        110372, 344, 4)
    assert TC.super_layout(bvh) == (8, 43) and not TC._use_flat(bvh)
    hier, sup, clu, _ = TC._kernel_tables(bvh, tdata.sup_planes,
                                          tdata.clu_planes, tdata.tri_planes)
    assert hier and sup.shape == (43, 6) and clu.shape == (43, 8, 6)


@pytest.mark.parametrize("fused", [False, True],
                         ids=["default", "fused_broadphase"])
def test_dragon_image_matches_reference(reference, fused):
    jr, tdata, tspec = reference
    cfg = RenderConfig(width=W, height=H, fused_broadphase=fused)
    img, stats = R.render_sample(tdata, tspec, cfg,
                                 R.make_pixel_offsets(cfg), 0)
    img = img.numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.max() > 0.01
    assert rmse(jr.image, img) < 1e-3
    assert np.abs(jr.image - img).max() < 5e-2
    assert int(stats["closest_rays"]) == jr.total_closest_rays
    assert int(stats["shadow_rays"]) == jr.total_shadow_rays


def test_dragon_bvh_image_matches_reference(reference):
    """The JAX CLI's path off a TPU, ported: the same image as the JAX
    renderer's, under the golden gate."""
    jr, tdata, tspec = reference
    assert jr.cfg.compaction and jr.cfg.tracer == "auto"
    cfg = RenderConfig(width=W, height=H, tracer="bvh", compaction=True)
    img, stats = R.render_sample(tdata, tspec, cfg,
                                 R.make_pixel_offsets(cfg), 0, tracer="bvh")
    img = img.numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.max() > 0.01
    assert rmse(jr.image, img) < 1e-3
    assert np.abs(jr.image - img).max() < 5e-2
    assert int(stats["closest_rays"]) == jr.total_closest_rays
    assert int(stats["shadow_rays"]) == jr.total_shadow_rays
