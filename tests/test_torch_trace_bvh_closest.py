"""The port's exact tracers' closest hit (``ops/trace.py``: the plain
packet walk and the brute force) against the JAX package's jitted packet
walk and brute force, on the CPU: one JAX build of plane_sphere (32x32) at
three (cluster size, branching) settings, carried to the port
(``torch_port_common.plane_sphere_build``), and the same seeded rays
(origins above the floor, unit directions) under a full, a partial and an
empty mask, with packets of 128 rays.

The gate is the JAX package's own (``tests/test_trace.py``): found masks
equal, t within rtol 1e-5, source triangles equal.  The JAX side runs
jitted, where XLA contracts multiply-adds and the port does not, so t and
the barycentrics differ in the last bits.
"""

import jax
import pytest
import torch

from metal_raytracing_tpu.ops import trace as JT
from metal_raytracing_tpu_torch.ops import trace as PT
from torch_port_common import (PACKET_BLOCK, PACKET_BUILDS, PACKET_CASE_IDS,
                               PACKET_CASES, PACKET_RAYS, assert_closest_gate,
                               few_torch_threads,  # noqa: F401
                               jax_of, packet_mask, packet_rays,
                               plane_sphere_build, torch_of)

# One compile per build: the spec and the block are static.
_jclosest = jax.jit(JT.trace_closest, static_argnames=("spec", "block"))
_jbrute = jax.jit(JT.trace_closest_bruteforce)


@pytest.fixture(scope="module")
def builds():
    """(cluster, branching) -> (JAX data, JAX spec, port data, port spec),
    each built once per test run."""
    return lambda key: plane_sphere_build(*key)


@pytest.mark.parametrize("build,mask_kind", PACKET_CASES, ids=PACKET_CASE_IDS)
def test_closest_matches_reference(builds, build, mask_kind):
    """The plain packet walk and the brute force against the JAX packet
    walk and brute force, and against each other (same rounding: t bit for
    bit, same slots)."""
    jdata, jspec, tdata, tspec = builds(build)
    assert tspec.bvh.max_stack == jspec.bvh.max_stack
    o, d, _ = packet_rays(PACKET_RAYS, 1)
    m = packet_mask(mask_kind, PACKET_RAYS)
    ref = _jclosest(*jax_of(o, d, m), jdata.geometry, jdata.node_lo,
                    jdata.node_hi, spec=jspec.bvh, block=PACKET_BLOCK)
    got = PT.trace_closest(*torch_of(o, d, m), tdata.geometry, tdata.node_lo,
                           tdata.node_hi, tspec.bvh, PACKET_BLOCK)
    got_bf = PT.trace_closest_bruteforce(*torch_of(o, d, m), tdata.geometry)
    src = tdata.tri_src.numpy()
    assert_closest_gate(got, ref.t, ref.tri, src, "packet vs JAX packet")
    assert_closest_gate(got_bf, ref.t, ref.tri, src,
                        "brute force vs JAX packet")
    # the JAX brute force compiles per table size
    if build == PACKET_BUILDS[-1]:
        ref_bf = _jbrute(*jax_of(o, d, m), jdata.geometry)
        assert_closest_gate(got_bf, ref_bf.t, ref_bf.tri, src,
                            "brute force vs JAX brute force")
    assert torch.equal(got.t, got_bf.t) and torch.equal(got.tri, got_bf.tri)
    assert torch.equal(got.u, got_bf.u) and torch.equal(got.v, got_bf.v)
    hits = int(got.found.sum())
    assert (hits == 0) == (mask_kind == "none")
    assert not got.found[~torch.from_numpy(m)].any()
