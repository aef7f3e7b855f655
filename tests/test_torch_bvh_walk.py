"""The walking plain versions of the BVH kernels
(``metal_raytracing_tpu_torch.ops.trace.closest_bvh_walk_ref`` /
``any_bvh_walk_ref``: each ray walks the tree with its own stack, as a lane
of ``closest_bvh_kernel`` / ``any_bvh_kernel`` does) against the JAX
package's packet walk (``metal_raytracing_tpu.ops.trace.trace_closest`` /
``trace_any``, jitted) and against the port's plain packet versions, on
the CPU.

The builds are ``test_torch_trace_bvh_closest.py``'s
(``torch_port_common.plane_sphere_build``): one JAX build of plane_sphere
(32x32) at three (cluster size, branching) settings, carried to the port,
with its seeded rays under a partial mask; then a full and an empty mask
and a ragged ray count, and a ten-triangle soup whose tree is a single leaf
(``levels == 0``).

Gates: against the JAX walk the JAX package's own (found masks equal, t
within rtol 1e-5, source triangles equal; flags equal), since XLA contracts
multiply-adds where the port does not; against the port's packet walk,
which rounds as the walk does, t bit for bit on every ray and slot, u, v
equal wherever the two pick the same slot (they may pick apart only where
two hits tie exactly: the packet orders a block's children by the block's
least entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu import accel as jaccel
from metal_raytracing_tpu.ops import trace as JT
from metal_raytracing_tpu.scene import GeometryTable as JGeometry
from metal_raytracing_tpu_torch import accel
from metal_raytracing_tpu_torch.ops import trace as PT
from metal_raytracing_tpu_torch.scene import GeometryTable
from torch_port_common import (PACKET_BLOCK, PACKET_BUILDS, PACKET_RAYS,
                               assert_closest_gate, jax_of, packet_mask,
                               packet_rays, plane_sphere_build, torch_of)

BUILD_IDS = [f"c{c}b{b}" for c, b in PACKET_BUILDS]

# One compile per build and query: the spec and the block are static.
_jclosest = jax.jit(JT.trace_closest, static_argnames=("spec", "block"))
_jany = jax.jit(JT.trace_any, static_argnames=("spec", "block"))


@pytest.fixture(scope="module")
def builds():
    """(cluster, branching) -> (JAX data, JAX spec, port data, port spec),
    each built once per test run."""
    return lambda key: plane_sphere_build(*key)


def assert_same_walk(got, ref, what):
    """t bit for bit on every ray; slot, u and v where the slots agree."""
    assert torch.equal(got.t.view(torch.int32), ref.t.view(torch.int32)), what
    assert torch.equal(got.found, ref.found), what
    agree = got.tri == ref.tri
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        assert torch.equal(a[agree].view(torch.int32),
                           b[agree].view(torch.int32)), what


def _tables(tdata, tspec):
    return tdata.geometry, tdata.node_lo, tdata.node_hi, tspec.bvh


@pytest.mark.parametrize("build", PACKET_BUILDS, ids=BUILD_IDS)
def test_closest_walk(builds, build):
    """Under a partial mask: against the JAX packet walk and the port's
    plain packet walk; masked rays miss."""
    jdata, jspec, tdata, tspec = builds(build)
    o, d, _ = packet_rays(PACKET_RAYS, 1)
    m = packet_mask("partial", PACKET_RAYS)
    got = PT.closest_bvh_walk_ref(*torch_of(o, d, m), *_tables(tdata, tspec))
    ref = _jclosest(*jax_of(o, d, m), jdata.geometry, jdata.node_lo,
                    jdata.node_hi, spec=jspec.bvh, block=PACKET_BLOCK)
    assert_closest_gate(got, ref.t, ref.tri, tdata.tri_src.numpy(),
                        "walk vs JAX packet")
    packet = PT.closest_packet_ref(*torch_of(o, d, m), *_tables(tdata, tspec),
                                   block=PACKET_BLOCK)
    assert_same_walk(got, packet, "walk vs packet")
    assert int(got.found.sum()) > 0
    assert not got.found[~torch.from_numpy(m)].any()


@pytest.mark.parametrize("build", PACKET_BUILDS, ids=BUILD_IDS)
def test_any_walk(builds, build):
    """Occlusion under a partial mask: equal to the JAX packet walk's and
    to the port's plain packet walk's flags."""
    jdata, jspec, tdata, tspec = builds(build)
    o, d, max_t = packet_rays(PACKET_RAYS, 3)
    m = packet_mask("partial", PACKET_RAYS)
    got = PT.any_bvh_walk_ref(*torch_of(o, d, max_t, m),
                              *_tables(tdata, tspec)).numpy()
    ref = np.asarray(_jany(*jax_of(o, d, max_t, m), jdata.geometry,
                           jdata.node_lo, jdata.node_hi, spec=jspec.bvh,
                           block=PACKET_BLOCK))
    np.testing.assert_array_equal(got, ref)
    packet = PT.any_packet_ref(*torch_of(o, d, max_t, m),
                               *_tables(tdata, tspec),
                               block=PACKET_BLOCK).numpy()
    np.testing.assert_array_equal(got, packet)
    assert 0 < got.sum() and not got[~m].any()


def test_full_empty_and_ragged(builds):
    """The default build under a full and an empty mask, against the JAX
    packet walk and the port's packet walk; a ray count that fills no block
    gives the rays' own results (the walk has no blocks)."""
    jdata, jspec, tdata, tspec = builds(PACKET_BUILDS[-1])
    tabs = _tables(tdata, tspec)
    jtabs = (jdata.geometry, jdata.node_lo, jdata.node_hi)
    o, d, max_t = packet_rays(PACKET_RAYS, 5)
    for kind in ("full", "none"):
        m = packet_mask(kind, PACKET_RAYS)
        got = PT.closest_bvh_walk_ref(*torch_of(o, d, m), *tabs)
        ref = _jclosest(*jax_of(o, d, m), *jtabs, spec=jspec.bvh,
                        block=PACKET_BLOCK)
        assert_closest_gate(got, ref.t, ref.tri, tdata.tri_src.numpy(),
                            f"{kind}: walk vs JAX packet")
        assert_same_walk(got, PT.closest_packet_ref(*torch_of(o, d, m), *tabs),
                         kind)
        occ = PT.any_bvh_walk_ref(*torch_of(o, d, max_t, m), *tabs)
        jocc = _jany(*jax_of(o, d, max_t, m), *jtabs, spec=jspec.bvh,
                     block=PACKET_BLOCK)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc),
                                      err_msg=kind)
        assert torch.equal(occ, PT.any_packet_ref(*torch_of(o, d, max_t, m),
                                                  *tabs)), kind
        assert (int(got.found.sum()) == 0) == (kind == "none")
    m = packet_mask("full", PACKET_RAYS)
    full = PT.closest_bvh_walk_ref(*torch_of(o, d, m), *tabs)
    part = PT.closest_bvh_walk_ref(*torch_of(o[:299], d[:299], m[:299]), *tabs)
    for a, b in zip((full.t, full.u, full.v, full.tri),
                    (part.t, part.u, part.v, part.tri)):
        assert torch.equal(a[:299], b)
    occ = PT.any_bvh_walk_ref(*torch_of(o, d, max_t, m), *tabs)
    occ_r = PT.any_bvh_walk_ref(*torch_of(o[:299], d[:299], max_t[:299],
                                          m[:299]), *tabs)
    assert torch.equal(occ[:299], occ_r)


def test_single_leaf_soup():
    """A ten-triangle soup: the root is the only (leaf) node (``levels ==
    0``), which the walk pops as its first leaf.  Against the JAX packet
    walk and brute force, and the port's packet walk."""
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
    o = rng.uniform(-3, 3, (PACKET_BLOCK, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (PACKET_BLOCK, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    max_t = rng.uniform(1.0, 5.0, PACKET_BLOCK).astype(np.float32)
    m = packet_mask("partial", PACKET_BLOCK)
    tabs = (geom, torch.from_numpy(lo), torch.from_numpy(hi), spec)
    got = PT.closest_bvh_walk_ref(*torch_of(o, d, m), *tabs)
    src = np.where(order >= 0, order, -1)
    ref = JT.trace_closest(*jax_of(o, d, m), jgeom, *jax_of(jlo, jhi), jspec,
                           block=PACKET_BLOCK)
    assert_closest_gate(got, ref.t, ref.tri, src, "levels 0 vs JAX packet")
    ref_bf = JT.trace_closest_bruteforce(*jax_of(o, d, m), jgeom)
    assert_closest_gate(got, ref_bf.t, ref_bf.tri, src,
                        "levels 0 vs JAX brute force")
    assert_same_walk(got, PT.closest_packet_ref(*torch_of(o, d, m), *tabs),
                     "levels 0 vs packet")
    assert int(got.found.sum()) > 0
    occ = PT.any_bvh_walk_ref(*torch_of(o, d, max_t, m), *tabs).numpy()
    jocc = np.asarray(JT.trace_any(*jax_of(o, d, max_t, m), jgeom,
                                   *jax_of(jlo, jhi), jspec,
                                   block=PACKET_BLOCK))
    np.testing.assert_array_equal(occ, jocc)
    assert occ.any()
