"""The walking plain versions of the hierarchical kernels
(``closest_hier_ref`` for K3, ``any_hier_ref`` for K4) against the JAX
package's hierarchical Pallas kernels run in interpret mode, on coatball
64x48 with ``flat=False`` (37 clusters, 5 supers of 8; the recorded passes of
one port sample, ``torch_port_common.walk_scenes``).

The tolerance: ids (flags) equal on >= 99.9% of live rays and every id
mismatch a near-tie within 2^-13 relative; the chopped t of one winner
within 2^-13 relative plus 1e-4 absolute, since interpret mode fuses
multiply-adds that the port rounds op by op (``tests/test_torch_trace.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (MIN_MATCH, NEAR_TIE_REL, assert_near_ties,
                               few_torch_threads,  # noqa: F401
                               hier_tables, traversal_block, walk_scenes)


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec, passes)."""
    return walk_scenes("coatball")


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("bounce", [0, 1])
def test_closest_walk_matches_hierarchical_kernel(scenes, bounce):
    jdata, jspec, tdata, tspec, calls = scenes["coatball"]
    o, d, m, seed = calls["closest"][bounce]
    ref = TP.trace_closest(_j(o), _j(d), _j(m), jdata.sup_planes,
                           jdata.clu_planes, jdata.tri_planes, jspec.bvh,
                           block=traversal_block(bounce), seed_key=_j(seed),
                           exact_uv=False, flat=False)
    t, tri, _ = TC.closest_hier_ref(o, d, m, *hier_tables(tdata, tspec), seed)
    live, tri, jtri = m.numpy(), tri.numpy(), np.asarray(ref.tri)
    assert ((tri == jtri) & live).sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri, jtri, live, tdata.tri_planes)
    both = live & (tri == jtri) & (tri >= 0)
    np.testing.assert_allclose(t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=NEAR_TIE_REL, atol=1e-4)
    np.testing.assert_array_equal(tri[~live], jtri[~live])


@pytest.mark.parametrize("bounce", [0, 1])
def test_any_walk_matches_hierarchical_kernel(scenes, bounce):
    jdata, jspec, tdata, tspec, calls = scenes["coatball"]
    o, d, mt, m = calls["any"][bounce]
    ref = np.asarray(TP.trace_any(
        _j(o), _j(d), _j(mt), _j(m), jdata.sup_planes, jdata.clu_planes,
        jdata.tri_planes, jspec.bvh, block=traversal_block(bounce),
        flat=False, seed_global=False))
    occ, _ = TC.any_hier_ref(o, d, mt, m, *hier_tables(tdata, tspec))
    live = m.numpy()
    assert ((occ.numpy() == ref) & live).sum() >= MIN_MATCH * live.sum()
    assert not occ.numpy()[~live].any() and not ref[~live].any()
