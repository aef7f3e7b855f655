"""The flat kernels' schedule (K1, K2) on coatball 64x48, on the CPU: the
warp's shared leaf test in a numpy model (``model_closest`` /
``model_any``, ``torch_port_common.py``) against the walking plain versions
``closest_flat_walk_ref`` / ``any_flat_walk_ref``, exactly; K2's global test
over the ``num_global`` real slots against the padded 128; and the flat
walks under an all-false mask and at ragged ray counts.  Set-up as in
``tests/test_torch_flat_walk.py``.
"""

import numpy as np
import pytest
import torch

from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (STEP, WARP, few_torch_threads,  # noqa: F401
                               flat_tables, model_any, model_closest,
                               numpy_of, walk_scenes)

FLAT_CASES = [(0, 1024, 512), (1, 0, 1000)]
FLAT_IDS = [f"bounce{b}-{n}rays" for b, _, n in FLAT_CASES]


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec, passes)."""
    return walk_scenes("coatball")


@pytest.mark.parametrize("bounce,start,count", FLAT_CASES, ids=FLAT_IDS)
def test_warp_model_gives_the_flat_closest_walks_keys(scenes, bounce, start,
                                                      count):
    _, _, tdata, tspec, calls = scenes["coatball"]
    o, d, m, seed = (x[start:start + count] for x in calls["closest"][bounce])
    rounds = []
    t, tri, visits = TC.closest_flat_walk_ref(o, d, m,
                                              *flat_tables(tdata, tspec),
                                              seed, rounds=rounds)
    assert len(rounds) == int(visits.max()) >= 2
    mt, mtri, steps = model_closest(*numpy_of(o, d, m, seed), None,
                                    tdata.tri_planes.numpy(), tspec.bvh,
                                    numpy_of(*rounds))
    np.testing.assert_array_equal(mtri, tri.numpy())
    np.testing.assert_array_equal(mt.view(np.int32),
                                  t.numpy().view(np.int32))
    assert steps == int(visits.sum()) * -(-tspec.bvh.cluster_size // STEP)


@pytest.mark.parametrize("bounce,start,count", FLAT_CASES, ids=FLAT_IDS)
def test_warp_model_gives_the_flat_any_walks_flags(scenes, bounce, start,
                                                   count):
    _, _, tdata, tspec, calls = scenes["coatball"]
    bvh = tspec.bvh
    o, d, mt, m = (x[start:start + count] for x in calls["any"][bounce])
    rounds = []
    occ, visits = TC.any_flat_walk_ref(o, d, mt, m,
                                       *flat_tables(tdata, tspec),
                                       rounds=rounds)
    got, steps = model_any(*numpy_of(o, d, mt, m), tdata.tri_planes.numpy(),
                           bvh, numpy_of(*rounds), g_slots=bvh.num_global)
    np.testing.assert_array_equal(got, occ.numpy())
    chunks = -(-bvh.cluster_size // STEP)
    most = int(visits.sum()) * chunks + int(m.sum()) * -(-bvh.num_global
                                                         // STEP)
    assert 0 < steps <= most and (steps < most) == bool(occ.any())


def test_global_test_over_the_real_slots_gives_the_same_flags(scenes):
    """K2 tests the ``num_global`` real global slots, not the 128-slot
    ``padded_global`` chunk: the padding slots are zero planes, never hit.
    On unbounded segments (where the floor and walls occlude many rays)
    and on a recorded shadow pass, in plain PyTorch and in the warp model."""
    _, _, tdata, tspec, calls = scenes["coatball"]
    bvh, tri = tspec.bvh, tdata.tri_planes
    gb, ng, pg = bvh.global_base, bvh.num_global, bvh.padded_global
    assert 0 < ng < pg
    o, d, m, _ = calls["closest"][1]
    mt = torch.full((o.shape[0],), TC.BIG_T)
    flags = []
    for width in (ng, pg):
        t, hit = TC._plane_hits(o, d, tri[:, gb:gb + width])
        flags.append((hit & (t <= mt[:, None])).any(dim=1) & m)
    assert torch.equal(*flags) and bool(flags[0].any())
    assert torch.equal(flags[0], TC.global_any_hit(o, d, mt, m, tri, bvh))
    o, d, mt, m = (x[:256] for x in calls["any"][0])
    mt = torch.full_like(mt, TC.BIG_T)  # unbounded: the globals occlude
    real = model_any(*numpy_of(o, d, mt, m), tri.numpy(), bvh, [],
                     g_slots=ng)
    padded = model_any(*numpy_of(o, d, mt, m), tri.numpy(), bvh, [],
                       g_slots=pg)
    np.testing.assert_array_equal(real[0], padded[0])
    assert real[0].any() and real[1] < padded[1]


def test_flat_walk_all_false_mask_leaves_every_ray_at_its_seed(scenes):
    _, _, tdata, tspec, calls = scenes["coatball"]
    o, d, _, seed = calls["closest"][1]
    none = torch.zeros(o.shape[0], dtype=torch.bool)
    rounds = []
    t, tri, visits = TC.closest_flat_walk_ref(o, d, none,
                                              *flat_tables(tdata, tspec), seed,
                                              rounds=rounds)
    rt, rtri = TC.closest_flat_ref(o, d, none, tdata.tri_planes, tspec.bvh,
                                   seed)
    assert torch.equal(t, rt) and torch.equal(tri, rtri)
    assert torch.equal(t, TC._key_to_t(seed))
    assert not visits.any() and rounds == []
    o2, d2, mt, _ = calls["any"][1]
    occ, visits = TC.any_flat_walk_ref(o2, d2, mt, none,
                                       *flat_tables(tdata, tspec),
                                       rounds=rounds)
    assert not occ.any() and not visits.any() and rounds == []


@pytest.mark.parametrize("n", [1, 31, 1000])
def test_flat_walk_ragged_ray_counts(scenes, n):
    """A walk is per ray: the first n rays give the first n results."""
    _, _, tdata, tspec, calls = scenes["coatball"]
    assert n % WARP
    o, d, m, seed = calls["closest"][1]
    full = TC.closest_flat_walk_ref(o, d, m, *flat_tables(tdata, tspec), seed)
    part = TC.closest_flat_walk_ref(o[:n], d[:n], m[:n],
                                    *flat_tables(tdata, tspec), seed[:n])
    for a, b in zip(full, part):
        assert torch.equal(a[:n], b)
    o2, d2, mt, m2 = calls["any"][1]
    full = TC.any_flat_walk_ref(o2, d2, mt, m2, *flat_tables(tdata, tspec))
    part = TC.any_flat_walk_ref(o2[:n], d2[:n], mt[:n], m2[:n],
                                *flat_tables(tdata, tspec))
    for a, b in zip(full, part):
        assert torch.equal(a[:n], b)
