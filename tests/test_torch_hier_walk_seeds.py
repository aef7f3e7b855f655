"""The walking plain version of K3 (``closest_hier_ref``) from its seeds,
and both hierarchical walks (K3, K4 ``any_hier_ref``) under an all-false
mask and at ragged ray counts, on the CPU: a per-ray seed and seed base
from the rank walk (against brute force, and on coatball against the JAX
package's interpret-mode hierarchical kernel), no seed at all, and rays
that leave every walk at its seed.  Set-ups and tolerances as in
``tests/test_torch_hier_walk_brute_force.py`` and
``tests/test_torch_hier_walk_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (MIN_MATCH, WARP, assert_near_ties,
                               few_torch_threads,  # noqa: F401
                               hier_tables, in_cluster, rank_seed,
                               walk_scenes)


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec, passes)."""
    return walk_scenes("coatball", "dragon")


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_closest_walk_with_seed_base(scenes, scene):
    jdata, jspec, tdata, tspec, calls = scenes[scene]
    (o, d, m), key, base = rank_seed(tdata, tspec, calls)
    t, tri, visits = TC.closest_hier_ref(o, d, m, *hier_tables(tdata, tspec),
                                         key, base)
    rt, rtri = TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh, key,
                                   base)
    live = m.numpy()
    assert ((tri == rtri).numpy() & live).sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri.numpy(), rtri.numpy(), live, tdata.tri_planes)
    # a seed that no cluster beats keeps its own base, and being a good
    # seed it cuts the walk: fewer visits than from the global seed alone
    kept = m & (t == TC._key_to_t(key)) & (tri >= 0)
    assert bool(kept.any())
    assert torch.equal(tri[kept], (base + (key & TC.IDX_MASK))[kept])
    _, _, unseeded = TC.closest_hier_ref(o, d, m, *hier_tables(tdata, tspec),
                                         calls["closest"][1][3])
    assert int(visits.sum()) < int(unseeded.sum())
    if scene == "coatball":
        ref = TP.trace_closest(_j(o), _j(d), _j(m), jdata.sup_planes,
                               jdata.clu_planes, jdata.tri_planes, jspec.bvh,
                               seed_key=_j(key), seed_base=_j(base),
                               exact_uv=False, flat=False)
        jtri = np.asarray(ref.tri)
        assert ((tri.numpy() == jtri) & live).sum() >= MIN_MATCH * live.sum()
        assert_near_ties(o, d, tri.numpy(), jtri, live, tdata.tri_planes)


def test_walk_without_a_seed_ignores_the_global_set(scenes):
    _, _, tdata, tspec, calls = scenes["coatball"]
    o, d, m, _ = calls["closest"][0]
    t, tri, _ = TC.closest_hier_ref(o, d, m, *hier_tables(tdata, tspec))
    rt, rtri = TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh)
    assert torch.equal(tri, rtri) and torch.equal(t, rt)
    # without the seed the floor and the walls are missed, not hit
    assert bool((tri < 0).any())
    assert in_cluster(tri[tri >= 0], tspec.bvh).all()


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_all_false_mask_leaves_every_ray_at_its_seed(scenes, scene):
    _, _, tdata, tspec, calls = scenes[scene]
    o, d, _, seed = calls["closest"][1]
    none = torch.zeros(o.shape[0], dtype=torch.bool)
    rounds = []
    t, tri, visits = TC.closest_hier_ref(o, d, none,
                                         *hier_tables(tdata, tspec), seed,
                                         rounds=rounds)
    rt, rtri = TC.closest_flat_ref(o, d, none, tdata.tri_planes, tspec.bvh,
                                   seed)
    assert torch.equal(t, rt) and torch.equal(tri, rtri)
    assert torch.equal(t, TC._key_to_t(seed))
    assert not visits.any() and rounds == []
    o2, d2, mt, _ = calls["any"][1]
    occ, visits = TC.any_hier_ref(o2, d2, mt, none,
                                  *hier_tables(tdata, tspec))
    assert not occ.any() and not visits.any()


@pytest.mark.parametrize("n", [1, 31, 1000])
def test_ragged_ray_counts(scenes, n):
    """A walk is per ray: the first n rays give the first n results."""
    _, _, tdata, tspec, calls = scenes["coatball"]
    assert n % WARP
    o, d, m, seed = calls["closest"][1]
    full = TC.closest_hier_ref(o, d, m, *hier_tables(tdata, tspec), seed)
    part = TC.closest_hier_ref(o[:n], d[:n], m[:n],
                               *hier_tables(tdata, tspec), seed[:n])
    for a, b in zip(full, part):
        assert torch.equal(a[:n], b)
    o2, d2, mt, m2 = calls["any"][1]
    full = TC.any_hier_ref(o2, d2, mt, m2, *hier_tables(tdata, tspec))
    part = TC.any_hier_ref(o2[:n], d2[:n], mt[:n], m2[:n],
                           *hier_tables(tdata, tspec))
    for a, b in zip(full, part):
        assert torch.equal(a[:n], b)
