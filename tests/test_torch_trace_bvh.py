"""The port's exact tracers (``metal_raytracing_tpu_torch.ops.trace``) and
their primitives (``ops.intersect``) against the JAX package's
(``metal_raytracing_tpu.ops.trace``, ``.ops.intersect``) on the CPU.

The primitives see the same seeded inputs on both sides, degenerate
triangles and the inverted empty-leaf box included.  The tracers see one
JAX build of plane_sphere (32x32) carried to the port
(``torch_port_common.plane_sphere_build``) with seeded rays at a ragged
count and on CPU tensors, and a ten-triangle soup whose tree is a single
leaf (``levels == 0``); their cases at three (cluster size, branching)
settings under a full, a partial and an empty mask are in
``tests/test_torch_trace_bvh_closest.py`` and
``tests/test_torch_trace_bvh_any.py``.  Then the renderer's exact path on
that plane_sphere build: ``tracer="bruteforce"`` gives the ``bvh`` image, no
cluster-tracer pass runs whatever the cluster knobs say, and ``render
--tracer bvh --device cpu`` renders.

The gate is the JAX package's own (``tests/test_trace.py``): found masks
equal, t within rtol 1e-5, source triangles equal; occlusion flags equal.
The JAX side runs jitted, where XLA contracts multiply-adds and the port
does not, so t and the barycentrics differ in the last bits.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu import accel as jaccel
from metal_raytracing_tpu.ops import intersect as JI
from metal_raytracing_tpu.ops import trace as JT
from metal_raytracing_tpu.scene import GeometryTable as JGeometry
from metal_raytracing_tpu_torch import accel
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.cli import main as cli_main
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import intersect as PI
from metal_raytracing_tpu_torch.ops import trace as PT
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.scene import GeometryTable
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (PACKET_BLOCK, PACKET_BUILDS, PACKET_RAYS,
                               assert_closest_gate, assert_image_gate,
                               few_torch_threads,  # noqa: F401
                               jax_of, packet_mask, packet_rays,
                               plane_sphere_build, torch_of)


@pytest.fixture(scope="module")
def builds():
    """(cluster, branching) -> (JAX data, JAX spec, port data, port spec),
    each built once per test run."""
    return lambda key: plane_sphere_build(*key)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def test_safe_inverse_equals_reference():
    rng = np.random.RandomState(0)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d[:8] = 0.0
    d[8:16] = np.float32(1e-13)
    d[16:24] = -np.float32(1e-13)
    d[24:32] = -0.0
    got = PI.safe_inverse(torch.from_numpy(d)).numpy()
    ref = np.asarray(JI.safe_inverse(jnp.asarray(d)))
    np.testing.assert_array_equal(got, ref)
    assert np.isfinite(got).all()


def test_ray_aabb_equals_reference():
    """Hit flags equal and entry t equal (eager jnp rounds op by op, as the
    port does), on boxes that contain, miss, lie behind the ray, and on the
    inverted empty-leaf sentinel."""
    rng = np.random.RandomState(1)
    n = 512
    o, d, max_t = packet_rays(n, 2)
    c = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    h = rng.uniform(0.05, 2.0, (n, 3)).astype(np.float32)
    lo, hi = c - h, c + h
    lo[:32] = np.float32(np.inf)  # the BVH build's padding leaves
    hi[:32] = -np.float32(np.inf)
    lo[32:64], hi[32:64] = o[32:64] - 0.5, o[32:64] + 0.5  # o inside
    inv = PI.safe_inverse(torch.from_numpy(d))
    tn, hit = PI.ray_aabb(*torch_of(o), inv, *torch_of(lo, hi, max_t))
    jtn, jhit = JI.ray_aabb(*jax_of(o), JI.safe_inverse(jnp.asarray(d)),
                            *jax_of(lo, hi, max_t))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(tn.numpy()[hit.numpy()],
                                  np.asarray(jtn)[np.asarray(jhit)])
    assert not hit[:32].any() and hit[32:64].all()
    assert 0 < int(hit.sum()) < n


def test_moller_trumbore_equals_reference():
    """Every (ray, triangle) pair of seeded rays and triangles, with zero,
    collinear and tiny triangles mixed in: hit flags equal, t, u and v
    within 1e-6 relative (the two packages may order the three-term sums
    differently)."""
    rng = np.random.RandomState(3)
    o, d, _ = packet_rays(128, 4)
    v0 = rng.uniform(-3, 3, (96, 3)).astype(np.float32)
    e1 = rng.uniform(-2, 2, (96, 3)).astype(np.float32)
    e2 = rng.uniform(-2, 2, (96, 3)).astype(np.float32)
    v0[:8] = e1[:8] = e2[:8] = 0.0  # padding slots
    e2[8:16] = 2.0 * e1[8:16]  # collinear edges: det = 0
    e1[16:24] *= 1e-7  # |det| below 1e-12
    args = (o[:, None], d[:, None], v0[None], e1[None], e2[None])
    t, u, v, hit = PI.moller_trumbore(*torch_of(*args))
    jt, ju, jv, jhit = JI.moller_trumbore(*jax_of(*args))
    hit = hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(jhit))
    assert not hit[:, :24].any() and 0 < hit.sum() < hit.size
    for a, b in ((t, jt), (u, ju), (v, jv)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-6, atol=1e-6)
    # t_max bounds the segment, t_min the start
    _, _, _, hit_t = PI.moller_trumbore(*torch_of(*args), t_max=1.0)
    assert not (hit_t.numpy() & ~(hit & (t.numpy() <= 1.0))).any()


# ---------------------------------------------------------------------------
# The tracers on plane_sphere
# ---------------------------------------------------------------------------


def test_ragged_ray_count_and_block(builds):
    """A ray count that fills no block gives the per-ray results of whole
    blocks; the packet size changes no hit distance."""
    _, _, tdata, tspec = builds((64, 8))
    o, d, max_t = packet_rays(PACKET_RAYS, 5)
    m = packet_mask("partial", PACKET_RAYS)
    args = (tdata.geometry, tdata.node_lo, tdata.node_hi, tspec.bvh)
    full = PT.closest_packet_ref(*torch_of(o, d, m), *args, block=PACKET_BLOCK)
    ragged = PT.closest_packet_ref(*torch_of(o[:300], d[:300], m[:300]),
                                   *args, block=PACKET_BLOCK)
    assert torch.equal(ragged.t, full.t[:300])
    small = PT.closest_packet_ref(*torch_of(o, d, m), *args, block=32)
    assert torch.equal(small.t, full.t)
    occ = PT.any_packet_ref(*torch_of(o, d, max_t, m), *args,
                            block=PACKET_BLOCK)
    occ_r = PT.any_packet_ref(*torch_of(o[:300], d[:300], max_t[:300],
                                        m[:300]), *args, block=PACKET_BLOCK)
    assert torch.equal(occ_r, occ[:300])


def test_cpu_tensors_take_the_plain_versions(builds):
    """On CPU tensors the wrappers run the plain packet walk (no launch is
    counted); tables that do not fit the spec raise."""
    _, _, tdata, tspec = builds((64, 8))
    o, d, max_t = packet_rays(256, 6)
    m = np.ones(256, bool)
    args = (tdata.geometry, tdata.node_lo, tdata.node_hi, tspec.bvh)
    before = (PT.trace_closest.launches, PT.trace_any.launches)
    hit = PT.trace_closest(*torch_of(o, d, m), *args)
    ref = PT.closest_packet_ref(*torch_of(o, d, m), *args)
    assert torch.equal(hit.tri, ref.tri) and torch.equal(hit.t, ref.t)
    occ = PT.trace_any(*torch_of(o, d, max_t, m), *args)
    assert torch.equal(occ, PT.any_packet_ref(*torch_of(o, d, max_t, m),
                                              *args))
    assert (PT.trace_closest.launches, PT.trace_any.launches) == before
    with pytest.raises(ValueError):
        PT.trace_closest(*torch_of(o, d, m), tdata.geometry,
                         tdata.node_lo[:-1], tdata.node_hi, tspec.bvh)
    with pytest.raises(ValueError):
        PT.trace_any(*torch_of(o, d, max_t.astype(np.float64), m), *args)


def test_single_cluster_scene():
    """A ten-triangle soup: the root is the only (leaf) node (``levels ==
    0``).  Both walks against the JAX packet walk and brute force."""
    rng = np.random.RandomState(9)
    ctr = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    v0 = ctr + rng.normal(scale=0.05, size=(10, 3)).astype(np.float32)
    e1 = rng.normal(scale=0.3, size=(10, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.3, size=(10, 3)).astype(np.float32)
    order, lo, hi, spec = accel.build_cluster_bvh(v0, e1, e2, cluster_size=16,
                                                  branching=8)
    jorder, jlo, jhi, jspec = jaccel.build_cluster_bvh(
        v0, e1, e2, cluster_size=16, branching=8, builder="sah_free")
    assert spec.levels == 0 and spec.first_leaf == 0
    np.testing.assert_array_equal(order, jorder)

    def permute(a):
        out = np.zeros((spec.padded_triangles, 3), np.float32)
        out[order >= 0] = a[order[order >= 0]]
        return out

    pv0, pe1, pe2 = permute(v0), permute(e1), permute(e2)
    geom = GeometryTable(*torch_of(pv0, pe1, pe2, pv0, pv0, pv0),
                         torch.zeros(spec.padded_triangles, dtype=torch.int32))
    jgeom = JGeometry(*jax_of(pv0, pe1, pe2, pv0, pv0, pv0),
                      jnp.zeros((spec.padded_triangles,), jnp.int32))
    # rays from around the soup toward its centre
    o = rng.uniform(-3, 3, (PACKET_BLOCK, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (PACKET_BLOCK, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    max_t = rng.uniform(1.0, 5.0, PACKET_BLOCK).astype(np.float32)
    m = packet_mask("partial", PACKET_BLOCK)
    tables = (torch.from_numpy(lo), torch.from_numpy(hi), spec)
    got = PT.trace_closest(*torch_of(o, d, m), geom, *tables, PACKET_BLOCK)
    ref = JT.trace_closest(*jax_of(o, d, m), jgeom, *jax_of(jlo, jhi), jspec,
                           block=PACKET_BLOCK)
    ref_bf = JT.trace_closest_bruteforce(*jax_of(o, d, m), jgeom)
    src = np.where(order >= 0, order, -1)
    assert_closest_gate(got, ref.t, ref.tri, src, "levels 0 vs JAX packet")
    assert_closest_gate(got, ref_bf.t, ref_bf.tri, src,
                        "levels 0 vs JAX brute force")
    assert int(got.found.sum()) > 0
    occ = PT.trace_any(*torch_of(o, d, max_t, m), geom, *tables,
                       PACKET_BLOCK).numpy()
    jocc = np.asarray(JT.trace_any(*jax_of(o, d, max_t, m), jgeom,
                                   *jax_of(jlo, jhi), jspec,
                                   block=PACKET_BLOCK))
    np.testing.assert_array_equal(occ, jocc)


# ---------------------------------------------------------------------------
# The renderer's exact path (plane_sphere 32x32's default build)
# ---------------------------------------------------------------------------


def port_image(tdata, tspec, w, h, tracer="bvh", **kw):
    cfg = RenderConfig(width=w, height=h, tracer=tracer, **kw)
    img, stats = R.render_sample(tdata, tspec, cfg, R.make_pixel_offsets(cfg),
                                 0, tracer=R.resolve_tracer(cfg, "cpu"))
    return img.numpy(), {k: int(v) for k, v in stats.items()}


def test_bruteforce_gives_the_bvh_image(builds):
    """The oracle and the BVH walk find the same hits at 16x16 under
    compaction=True: the same image."""
    _, _, tdata, tspec = builds(PACKET_BUILDS[-1])
    bvh, s_bvh = port_image(tdata, tspec, 16, 16, compaction=True)
    brute, s_brute = port_image(tdata, tspec, 16, 16, "bruteforce",
                                compaction=True)
    assert_image_gate(brute, bvh, "bruteforce against bvh")
    assert np.array_equal(brute, bvh)
    assert s_bvh == s_brute


def test_exact_path_skips_the_cluster_passes(builds, monkeypatch):
    """The exact tracers test the global set themselves and sort by the
    dir_major / light-major keys: no host-side global pass, no cluster
    broad phase, no rank walk runs, whatever the cluster knobs say."""
    _, _, tdata, tspec = builds(PACKET_BUILDS[-1])

    def refuse(*args, **kwargs):
        raise AssertionError("a cluster-tracer pass ran on the exact path")

    for mod, names in ((TC, ("global_seed_keys", "global_any_hit",
                             "closest_flat_ref", "any_flat_ref")),
                       (BP, ("broadphase_ref",)),
                       (R, ("nearest_cluster", "nearest_cluster_pair",
                            "broadphase_ref"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    img, _ = port_image(tdata, tspec, 16, 16, compaction=True,
                        fused_broadphase=True, rank_trace=2)
    assert np.isfinite(img).all() and img.max() > 0.01
    monkeypatch.undo()
    plain, _ = port_image(tdata, tspec, 16, 16, compaction=True)
    assert np.array_equal(img, plain)  # the knobs are silently off


def test_cli_renders_bvh_on_the_cpu(tmp_path):
    out = tmp_path / "bvh.png"
    assert cli_main(["render", "--scene", "plane_sphere", "--size", "16x16",
                     "--spp", "1", "--tracer", "bvh", "--compaction",
                     "--device", "cpu", "--out", str(out), "--quiet"]) == 0
    assert out.stat().st_size > 0
    cfg = RenderConfig(tracer="bvh")
    assert R.resolve_tracer(cfg, "cpu") == "bvh"
    assert R.resolve_tracer(dataclasses.replace(cfg, tracer="auto"),
                            "cpu") == "torch"
