"""Each cluster builder's image in the port against the JAX renderer's,
on the CPU: plane_sphere 32x32, one sample of two bounces, through the port's plain
tracers and the JAX renderer's CPU tracer, both built with the same builder
(``RenderConfig.bvh_builder``, ``bvh_presplit``), within the JAX package's
golden gate (RMSE < 1e-3, max < 5e-2) and with the same spec and ray
counts.  At ``cluster_size=128``: ploc's clusters hold a few triangles
each and the JAX CPU tracer tests every padded slot, and ``sah_chunk``
needs clusters of at least its 128-slot chunk (below that, both packages'
builds write clusters over each other; ROADMAP.md, Queue 3).
"""

import numpy as np
import pytest

from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.io.image import rmse
from metal_raytracing_tpu.renderer import Renderer as JRenderer
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.io import procedural as tproc
from metal_raytracing_tpu_torch.scenes import library as tlib
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import few_torch_threads  # noqa: F401
from torch_port_common import BUILDS

SIZE = 32
BOUNCES = 2  # each bounce is one more JAX compile


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


# sah_free's image: tests/test_torch_renderer.py; the pre-split leaves
# plane_sphere's build as sah_free's (its large triangles are the global
# set), and its build is held in tests/test_torch_builders.py.
IMAGE_BUILDS = sorted(set(BUILDS) - {"sah_free", "presplit"})


@pytest.mark.parametrize("label", IMAGE_BUILDS)
def test_builder_image_matches_reference(label):
    """plane_sphere 32x32, one sample, through the port's plain tracers and
    the JAX renderer (its CPU tracer), both built with this builder."""
    kw = dict(bvh_builder=BUILDS[label]["builder"], cluster_size=128,
              bvh_presplit=BUILDS[label].get("presplit", 0.0),
              max_bounces=BOUNCES)
    jr = JRenderer(jlib.get_scene("plane_sphere", SIZE, SIZE),
                   JConfig(width=SIZE, height=SIZE, **kw))
    tr = R.Renderer(tlib.get_scene("plane_sphere", SIZE, SIZE),
                    RenderConfig(width=SIZE, height=SIZE, **kw),
                    device="cpu")
    assert repr(tr.spec.bvh) == repr(jr.spec.bvh)
    a, b = jr.render(1), tr.render(1)
    assert b.shape == (SIZE, SIZE, 3) and np.isfinite(b).all()
    assert b.max() > 0.01
    assert rmse(a, b) < 1e-3
    assert np.abs(a - b).max() < 5e-2
    assert tr.total_closest_rays == jr.total_closest_rays
