"""The walking plain versions of the hierarchical kernels
(``closest_hier_ref`` for K3, ``any_hier_ref`` for K4) against the
brute-force plain versions, on the CPU.

The CUDA kernels keep one walk per lane (two levels in K3/K4) and let the 32
lanes of a warp share each requested cluster's leaf test; the walk is held
here in the plain versions that take the kernels' picks ray by ray.  Set-ups
(``torch_port_common.walk_scenes``): coatball at 64x48 with ``flat=False``
(37 clusters, 5 supers of 8) and dragon at 32x24 (344 clusters, 43 supers of
8).  Rays are the recorded passes of one port sample.

The tolerance: the same plane test in the same op order, so the chopped t
of one winner is equal bit for bit; ids (flags) equal on >= 99.9% of live
rays and every id mismatch a near-tie within 2^-13 relative, because the
walk skips a cluster whose entry is not strictly below the running best and
brute force does not (measured: 0 mismatches on every pass here).
"""

import pytest
import torch

from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (MIN_MATCH, assert_near_ties, brute_force_pass,
                               few_torch_threads,  # noqa: F401
                               hier_tables, in_cluster, walk_scenes)

PASSES = [("coatball", 0), ("coatball", 1), ("dragon", 0), ("dragon", 1)]
IDS = [f"{scene}-bounce{b}" for scene, b in PASSES]


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec, passes)."""
    return walk_scenes("coatball", "dragon")


@pytest.fixture(scope="module")
def brute():
    """(scene, kind, bounce) -> the brute-force plain version's result on
    that recorded pass (``closest_flat_ref`` or ``any_flat_ref``)."""
    return brute_force_pass


@pytest.mark.parametrize("scene,bounce", PASSES, ids=IDS)
def test_closest_walk_matches_brute_force(scenes, brute, scene, bounce):
    _, _, tdata, tspec, calls = scenes[scene]
    o, d, m, seed = calls["closest"][bounce]
    t, tri, visits = TC.closest_hier_ref(o, d, m, *hier_tables(tdata, tspec),
                                         seed)
    rt, rtri = brute(scene, "closest", bounce)
    live = m.numpy()
    assert live.sum() > 0
    same = (tri == rtri).numpy() & live
    assert same.sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri.numpy(), rtri.numpy(), live, tdata.tri_planes)
    assert torch.equal(t[torch.from_numpy(same)], rt[torch.from_numpy(same)])
    assert torch.equal(tri[~m], rtri[~m]) and torch.equal(t[~m], rt[~m])
    # a ray that hits a cluster visited one; a masked ray visited none
    assert (visits[in_cluster(tri, tspec.bvh) & m] >= 1).all()
    assert (visits[~m] == 0).all() and int(visits.max()) >= 2
    # the cull shows: no ray visits every cluster its supers hold
    assert int(visits.max()) < tspec.bvh.num_clusters


@pytest.mark.parametrize("scene,bounce", PASSES, ids=IDS)
def test_any_walk_matches_brute_force(scenes, brute, scene, bounce):
    _, _, tdata, tspec, calls = scenes[scene]
    o, d, mt, m = calls["any"][bounce]
    occ, visits = TC.any_hier_ref(o, d, mt, m, *hier_tables(tdata, tspec))
    ref = brute(scene, "any", bounce)
    live = m.numpy()
    assert live.sum() > 0 and bool(occ[m].any()) and not bool(occ[m].all())
    assert ((occ == ref).numpy() & live).sum() >= MIN_MATCH * live.sum()
    assert not occ[~m].any() and (visits[~m] == 0).all()
    assert int(visits.max()) >= 2
    # a ray the global set occludes never starts its walk (the renderer
    # takes those out of the shadow mask first, so: the closest pass's rays
    # as unbounded segments, many of which end on the floor or a wall)
    o, d, m, _ = (x[:512] for x in calls["closest"][bounce])
    mt = torch.full((o.shape[0],), TC.BIG_T)
    g = TC.global_any_hit(o, d, mt, m, tdata.tri_planes, tspec.bvh)
    occ, visits = TC.any_hier_ref(o, d, mt, m, *hier_tables(tdata, tspec))
    assert bool(g.any()) and (visits[g] == 0).all() and occ[g].all()
    assert torch.equal(occ, TC.any_flat_ref(o, d, mt, m, tdata.tri_planes,
                                            tspec.bvh))
