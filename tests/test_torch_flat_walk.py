"""The walking plain versions of the flat kernels (``closest_flat_walk_ref``
for K1, ``any_flat_walk_ref`` for K2: one level over every cluster box) on
coatball 64x48 (all 40 cluster boxes, 3 of them padding; the recorded passes
of one port sample, ``torch_port_common.walk_scenes``) against the
brute-force plain versions and the JAX package's flat Pallas kernels run in
interpret mode, on the CPU.

Tolerances: against brute force the chopped t of one winner is equal bit
for bit and ids (flags) equal on >= 99.9% of live rays, every id mismatch a
near-tie within 2^-13 relative; against the interpret-mode kernels the same
ids rule, and the chopped t of one winner within 2^-13 relative plus 1e-4
absolute (interpret mode fuses multiply-adds that the port rounds op by
op).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (MIN_MATCH, NEAR_TIE_REL, assert_near_ties,
                               brute_force_pass, few_torch_threads,  # noqa
                               flat_tables, hier_tables, in_cluster,
                               traversal_block, walk_scenes)


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec, passes)."""
    return walk_scenes("coatball")


@pytest.fixture(scope="module")
def brute():
    """(scene, kind, bounce) -> the brute-force plain version's result on
    that recorded pass (``closest_flat_ref`` or ``any_flat_ref``)."""
    return brute_force_pass


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("bounce", [0, 1])
def test_flat_closest_walk_matches_brute_force(scenes, brute, bounce):
    _, _, tdata, tspec, calls = scenes["coatball"]
    o, d, m, seed = calls["closest"][bounce]
    t, tri, visits = TC.closest_flat_walk_ref(o, d, m,
                                              *flat_tables(tdata, tspec),
                                              seed)
    rt, rtri = brute("coatball", "closest", bounce)
    live = m.numpy()
    same = (tri == rtri).numpy() & live
    assert same.sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri.numpy(), rtri.numpy(), live, tdata.tri_planes)
    assert torch.equal(t[torch.from_numpy(same)], rt[torch.from_numpy(same)])
    assert torch.equal(tri[~m], rtri[~m]) and torch.equal(t[~m], rt[~m])
    assert (visits[in_cluster(tri, tspec.bvh) & m] >= 1).all()
    assert (visits[~m] == 0).all() and int(visits.max()) >= 2
    assert int(visits.max()) < tspec.bvh.num_clusters


@pytest.mark.parametrize("bounce", [0, 1])
def test_flat_any_walk_matches_brute_force(scenes, brute, bounce):
    _, _, tdata, tspec, calls = scenes["coatball"]
    o, d, mt, m = calls["any"][bounce]
    occ, visits = TC.any_flat_walk_ref(o, d, mt, m,
                                       *flat_tables(tdata, tspec))
    ref = brute("coatball", "any", bounce)
    live = m.numpy()
    assert bool(occ[m].any()) and not bool(occ[m].all())
    assert ((occ == ref).numpy() & live).sum() >= MIN_MATCH * live.sum()
    assert not occ[~m].any() and (visits[~m] == 0).all()
    assert int(visits.max()) >= 2
    # the flat walk and the two-level walk give the same flags
    assert torch.equal(occ, TC.any_hier_ref(o, d, mt, m,
                                            *hier_tables(tdata, tspec))[0])


@pytest.mark.parametrize("bounce", [0, 1])
def test_flat_closest_walk_matches_flat_kernel(scenes, bounce):
    jdata, jspec, tdata, tspec, calls = scenes["coatball"]
    o, d, m, seed = calls["closest"][bounce]
    ref = TP.trace_closest(_j(o), _j(d), _j(m), jdata.sup_planes,
                           jdata.clu_planes, jdata.tri_planes, jspec.bvh,
                           block=traversal_block(bounce), seed_key=_j(seed),
                           exact_uv=False, flat=True)
    t, tri, _ = TC.closest_flat_walk_ref(o, d, m, *flat_tables(tdata, tspec),
                                         seed)
    live, tri, jtri = m.numpy(), tri.numpy(), np.asarray(ref.tri)
    assert ((tri == jtri) & live).sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri, jtri, live, tdata.tri_planes)
    both = live & (tri == jtri) & (tri >= 0)
    np.testing.assert_allclose(t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=NEAR_TIE_REL, atol=1e-4)
    np.testing.assert_array_equal(tri[~live], jtri[~live])


@pytest.mark.parametrize("bounce", [0, 1])
def test_flat_any_walk_matches_flat_kernel(scenes, bounce):
    jdata, jspec, tdata, tspec, calls = scenes["coatball"]
    o, d, mt, m = calls["any"][bounce]
    ref = np.asarray(TP.trace_any(
        _j(o), _j(d), _j(mt), _j(m), jdata.sup_planes, jdata.clu_planes,
        jdata.tri_planes, jspec.bvh, block=traversal_block(bounce),
        flat=True, seed_global=False))
    occ, _ = TC.any_flat_walk_ref(o, d, mt, m, *flat_tables(tdata, tspec))
    live = m.numpy()
    assert ((occ.numpy() == ref) & live).sum() >= MIN_MATCH * live.sum()
    assert not occ.numpy()[~live].any() and not ref[~live].any()
