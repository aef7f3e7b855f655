"""The port's exact tracers' any hit (``ops/trace.py``: the plain packet
walk and the brute force) against the JAX package's jitted packet walk, on
the CPU: one JAX build of plane_sphere (32x32) at three (cluster size,
branching) settings, carried to the port
(``torch_port_common.plane_sphere_build``), and the same seeded segments
under a full, a partial and an empty mask, with packets of 128 rays.  The
gate is the JAX package's own (``tests/test_trace.py``): occlusion flags
equal.
"""

import jax
import numpy as np
import pytest

from metal_raytracing_tpu.ops import trace as JT
from metal_raytracing_tpu_torch.ops import trace as PT
from torch_port_common import (PACKET_BLOCK, PACKET_CASE_IDS, PACKET_CASES,
                               PACKET_RAYS, few_torch_threads,  # noqa: F401
                               jax_of, packet_mask, packet_rays,
                               plane_sphere_build, torch_of)

# One compile per build: the spec and the block are static.
_jany = jax.jit(JT.trace_any, static_argnames=("spec", "block"))


@pytest.fixture(scope="module")
def builds():
    """(cluster, branching) -> (JAX data, JAX spec, port data, port spec),
    each built once per test run."""
    return lambda key: plane_sphere_build(*key)


@pytest.mark.parametrize("build,mask_kind", PACKET_CASES, ids=PACKET_CASE_IDS)
def test_any_matches_reference(builds, build, mask_kind):
    """Occlusion of seeded segments: the plain packet walk equal to the JAX
    packet walk and to both brute forces."""
    jdata, jspec, tdata, tspec = builds(build)
    o, d, max_t = packet_rays(PACKET_RAYS, 3)
    m = packet_mask(mask_kind, PACKET_RAYS)
    ref = np.asarray(_jany(*jax_of(o, d, max_t, m), jdata.geometry,
                           jdata.node_lo, jdata.node_hi, spec=jspec.bvh,
                           block=PACKET_BLOCK))
    got = PT.trace_any(*torch_of(o, d, max_t, m), tdata.geometry,
                       tdata.node_lo, tdata.node_hi, tspec.bvh,
                       PACKET_BLOCK).numpy()
    got_bf = PT.trace_any_bruteforce(*torch_of(o, d, max_t, m),
                                     tdata.geometry).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_bf, ref)
    assert (got.sum() == 0) == (mask_kind == "none")
    assert not got[~m].any()
