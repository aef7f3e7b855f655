"""The baked-origin primary pass (``RenderConfig.bake_primary``) in the port
against the JAX package, on the CPU.

Every primary ray leaves the camera, so the JAX package moves the camera's
position into the plane tables (``trace_pallas.bake_origin``) and runs the
hierarchical closest kernel's ``baked=True`` form, which drops every origin
term.  The port's counterparts: ``trace_cuda.bake_origin``, the kernel's
baked form in ``csrc/trace_hier.cu`` (on the card only) and its plain
versions, ``closest_flat_ref`` / ``closest_hier_ref`` with ``baked=True``.
Here, on dragon 32x24 (344 clusters, the hierarchical kernels), from one
JAX build carried to the port:

- ``bake_origin`` bit-equal to the jitted JAX function, at the camera and at
  an origin off every axis (each dot's contraction order shows only where
  the origin's components are not 0);
- the baked walking plain version against the interpret-mode JAX kernel
  (``trace_pallas.trace_closest(baked_origin=True)``) on the recorded
  primary rays: ids equal on >= 99.9% of the live rays, every mismatch a
  near-tie (winners' exact t within 2^-13 relative), and against the baked
  brute force and the unbaked walk the same way (the baked u and v
  re-associate the barycentrics, so edge hits may flip);
- the renderer: ``bake_primary=True`` against the JAX renderer's
  ``bake_primary=True`` image (its Pallas tracer in interpret mode) at the
  golden gate, two bounces; the tables built once per ``Renderer`` and
  again after ``refine``; the knob off for flat scenes and the exact
  tracers; the fingerprint unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu import renderer as JR
from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.scenes import get_scene
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (MIN_MATCH, NEAR_TIE_REL,  # noqa: F401
                               assert_image_gate, assert_near_ties,
                               build_both, few_torch_threads, record_passes)

W, H = 32, 24
BOUNCES = 2
OFF_AXIS = (0.37, 1.13, 5.38)


@pytest.fixture(scope="module")
def dragon():
    """(JAX data, JAX spec, port data, port spec, the port's recorded
    primary pass (o, d, mask, seed), its baked tables)."""
    jdata, jspec, tdata, tspec = build_both("dragon", W, H)
    cfg = RenderConfig(width=W, height=H, max_bounces=1)
    primary = record_passes(tdata, tspec, cfg)["closest"][0]
    baked = TC.bake_origin(tdata.sup_planes, tdata.clu_planes,
                           tdata.tri_planes, tdata.camera.position)
    return jdata, jspec, tdata, tspec, primary, baked


def _bits(x):
    return np.asarray(x).view(np.int32)


def test_bake_origin_equals_jitted_reference(dragon):
    jdata, _, tdata, _, _, _ = dragon
    bake = jax.jit(TP.bake_origin)
    for origin in (np.asarray(jdata.camera.position),
                   np.asarray(OFF_AXIS, np.float32)):
        ref = bake(jdata.sup_planes, jdata.clu_planes, jdata.tri_planes,
                   jnp.asarray(origin))
        got = TC.bake_origin(tdata.sup_planes, tdata.clu_planes,
                             tdata.tri_planes, torch.tensor(origin))
        for name, g, r in zip(("sup", "clu", "tri"), got, ref):
            assert g.dtype == torch.float32 and g.shape == r.shape, name
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(r),
                                          err_msg=name)
    # the off-axis origin moved every row the bake touches
    assert not torch.equal(got[2][3], tdata.tri_planes[3])


def test_baked_walk_matches_interpret_kernel(dragon):
    jdata, jspec, tdata, tspec, (o, d, m, seed), baked = dragon
    bvh = tspec.bvh
    t, tri, visits = TC.closest_hier_ref(o, d, m, *baked, bvh, seed,
                                         baked=True)
    jb = TP.bake_origin(jdata.sup_planes, jdata.clu_planes, jdata.tri_planes,
                        jdata.camera.position)
    ref = TP.trace_closest(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                           jnp.asarray(m.numpy()), *jb, jspec.bvh,
                           seed_key=jnp.asarray(seed.numpy()),
                           baked_origin=True, block=128, exact_uv=False)
    live = m.numpy()
    ref_tri = np.asarray(ref.tri)
    assert (tri.numpy()[live] >= 0).mean() > 0.5  # the dragon, the floor
    assert (tri.numpy() == ref_tri)[live].mean() >= MIN_MATCH
    assert_near_ties(o, d, tri.numpy(), ref_tri, live, tdata.tri_planes)
    assert (visits[m] > 0).any() and (visits[~m] == 0).all()


def test_baked_walk_against_brute_force_and_unbaked(dragon):
    _, _, tdata, tspec, (o, d, m, seed), baked = dragon
    bvh = tspec.bvh
    tabs = (tdata.sup_planes, tdata.clu_planes, tdata.tri_planes, bvh)
    t, tri, _ = TC.closest_hier_ref(o, d, m, *baked, bvh, seed, baked=True)
    # the wrapper's CPU routes: the baked brute force, and with visits the
    # baked walk; a flat scene has no baked form
    hit = TC.trace_closest(o, d, m, *baked, bvh, seed, baked_origin=True)
    hit_v, vis = TC.trace_closest(o, d, m, *baked, bvh, seed,
                                  baked_origin=True, count_visits=True)
    assert torch.equal(hit_v.tri, tri) and torch.equal(hit_v.t, t)
    ut, utri, uvis = TC.closest_hier_ref(o, d, m, *tabs, seed)
    assert torch.equal(vis, uvis)  # lo * inv == (lo - 0) * inv: same picks
    live = m.numpy()
    for ref_t, ref_tri in ((hit.t, hit.tri), (ut, utri)):
        assert (tri == ref_tri).numpy()[live].mean() >= MIN_MATCH
        assert_near_ties(o, d, tri.numpy(), ref_tri.numpy(), live,
                         tdata.tri_planes)
        same = live & (tri == ref_tri).numpy() & (tri.numpy() >= 0)
        rel = ((t - ref_t).abs() / ref_t.abs()).numpy()[same]
        assert rel.max() <= NEAR_TIE_REL
    flat = build_both("plane_sphere", 32, 32)[2:]
    fo, fd = torch.zeros((4, 3)), torch.nn.functional.normalize(
        torch.randn(4, 3, generator=torch.Generator().manual_seed(0)), dim=1)
    with pytest.raises(ValueError, match="baked_origin"):
        TC.trace_closest(fo, fd, torch.ones(4, dtype=torch.bool),
                         flat[0].sup_planes, flat[0].clu_planes,
                         flat[0].tri_planes, flat[1].bvh, baked_origin=True)


def test_bake_primary_image_matches_reference(dragon):
    jdata, jspec, tdata, tspec, _, _ = dragon
    jcfg = JConfig(width=W, height=H, tracer="pallas", bake_primary=True,
                   max_bounces=BOUNCES)
    ref, _ = jax.jit(lambda dd, oo: JR.render_sample(
        dd, jspec, jcfg, oo, jnp.int32(0)))(jdata, JR.make_pixel_offsets(jcfg))
    ref = np.asarray(ref)
    # telemetry: the walking plain versions (the renderer's brute-force
    # route is test_renderer_bakes_once_a_build's), with the visits
    imgs = {}
    for bake in (True, False):
        cfg = RenderConfig(width=W, height=H, bake_primary=bake,
                           max_bounces=BOUNCES, telemetry=True)
        img, stats = R.render_sample(tdata, tspec, cfg,
                                     R.make_pixel_offsets(cfg), 0)
        imgs[bake] = img.numpy()
        assert stats["visits_b0"].shape[0] >= W * H  # the padded rays
    img = imgs[True]
    assert img.max() > 0.01 and np.isfinite(img).all()
    assert_image_gate(img, ref, "dragon bake_primary")
    assert_image_gate(img, imgs[False], "baked vs unbaked")


def test_renderer_bakes_once_a_build(monkeypatch):
    calls = []
    bake = TC.bake_origin
    monkeypatch.setattr(TC, "bake_origin",
                        lambda *a: calls.append(1) or bake(*a))
    kw = dict(width=16, height=16, max_bounces=1)
    r = R.Renderer(get_scene("dragon", 16, 16),
                   RenderConfig(bake_primary=True, **kw), device="cpu")
    assert r.baked is not None and len(calls) == 1
    fp = r.fingerprint()
    r.render(2)
    assert len(calls) == 1  # the samples reuse the renderer's tables
    assert r.refine(stride=8)
    assert len(calls) == 2 and r.baked[2].shape == r.data.tri_planes.shape
    plain = R.Renderer(get_scene("dragon", 16, 16), RenderConfig(**kw),
                       device="cpu")
    assert plain.baked is None and plain.fingerprint() == fp
    # flat scenes and the exact tracers ignore the knob, as the reference
    for scene, tracer in (("coatball", "auto"), ("dragon", "bvh")):
        r = R.Renderer(get_scene(scene, 16, 16),
                       RenderConfig(bake_primary=True, tracer=tracer, **kw),
                       device="cpu")
        assert r.baked is None
