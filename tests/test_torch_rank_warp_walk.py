"""The rank-directed closest walk (K6) as the warps of
``closest_rank_kernel`` take it, on the CPU: the walking plain version
``closest_rank_walk_ref`` against the plain version ``closest_rank_ref``
(with and without a seed, under an all-false mask, at ragged ray counts;
its visits against the clusters each ray must dense-test), and the warp's
grouped leaf service (``model_closest``, ``torch_port_common.py``) on the
walk's rounds, exactly.  Set-up: coatball 64x48's recorded closest passes
with their rank keys (``torch_port_common.rank_setup``), as in
``tests/test_torch_rank.py``.
"""

import numpy as np
import pytest
import torch

from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import rank_cuda as RK
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (STEP, WARP, decode_key,
                               few_torch_threads,  # noqa: F401
                               model_closest, rank_setup)


@pytest.fixture(scope="module")
def setup():
    """(JAX data, JAX spec, port data, port spec, passes) on coatball;
    each pass is ((o, d, mask), seed key, rank keys 1..3)."""
    return rank_setup()


def _rank_visits(o, d, m, k1, k2, tri, bvh, seed):
    """Clusters each ray must dense-test: rank 1 where its entry lies below
    the seed's chopped t, rank 2 where it lies below the best after rank
    1."""
    entry = lambda pk: (pk & ~BP.NC_IDM).view(torch.float32)
    start = TC._key_to_t(seed) if seed is not None else TC.BIG_T
    key1, _ = RK.closest_rank_ref(o, d, m, [k1], tri, bvh, seed)
    v1 = m & (k1 != BP.NC_SENT) & (entry(k1) < start)
    v2 = m & (k2 != BP.NC_SENT) & (entry(k2) < TC._key_to_t(key1))
    return v1.int() + v2.int()


@pytest.mark.parametrize("bounce", [0, 1, 2])
def test_rank_walking_plain_version_equals_plain_version(setup, bounce):
    _, _, tdata, tspec, passes = setup
    (o, d, m), seed, (k1, k2, _) = passes[bounce]
    args = (o, d, m, [k1, k2], tdata.tri_planes, tspec.bvh, seed)
    key, base = RK.closest_rank_ref(*args)
    wkey, wbase, visits, sizes = RK.closest_rank_walk_ref(*args)
    assert torch.equal(wkey, key) and torch.equal(wbase, base)
    assert torch.equal(visits, _rank_visits(o, d, m, k1, k2,
                                            tdata.tri_planes, tspec.bvh,
                                            seed))
    assert int(visits.max()) == 2 and not visits[~m].any()
    # every visit is served in one group of its warp's lanes
    assert int(sizes.sum()) == int(visits.sum())
    assert int(sizes.min()) >= 1 and int(sizes.max()) <= WARP


def test_rank_walking_plain_version_without_seed(setup):
    _, _, tdata, tspec, passes = setup
    (o, d, m), seed, (k1, k2, _) = passes[1]
    args = (o, d, m, [k1, k2], tdata.tri_planes, tspec.bvh)
    key, base = RK.closest_rank_ref(*args)
    wkey, wbase, visits, _ = RK.closest_rank_walk_ref(*args)
    assert torch.equal(wkey, key) and torch.equal(wbase, base)
    assert (wkey[~m] == TC._INIT_KEY).all() and not wbase[~m].any()
    assert torch.equal(visits, _rank_visits(o, d, m, k1, k2,
                                            tdata.tri_planes, tspec.bvh,
                                            None))
    # a seed can only cull candidates
    assert (visits >= RK.closest_rank_walk_ref(*args, seed)[2]).all()


def test_rank_walking_plain_version_all_false_mask(setup):
    _, _, tdata, tspec, passes = setup
    (o, d, m), seed, (k1, k2, _) = passes[1]
    rounds = []
    key, base, visits, sizes = RK.closest_rank_walk_ref(
        o, d, torch.zeros_like(m), [k1, k2], tdata.tri_planes, tspec.bvh,
        seed, rounds=rounds)
    assert torch.equal(key, seed)
    assert (base == tspec.bvh.global_base).all()
    assert not visits.any() and sizes.numel() == 0 and rounds == []


@pytest.mark.parametrize("n", [31, 1000])
def test_rank_walking_plain_version_ragged_ray_counts(setup, n):
    """A walk is per ray, whatever the warps: the first n rays give the
    first n results; the last warp is partial."""
    _, _, tdata, tspec, passes = setup
    (o, d, m), seed, (k1, k2, _) = passes[1]
    assert n % WARP
    tabs = (tdata.tri_planes, tspec.bvh)
    full = RK.closest_rank_walk_ref(o, d, m, [k1, k2], *tabs, seed)
    part = RK.closest_rank_walk_ref(o[:n], d[:n], m[:n], [k1[:n], k2[:n]],
                                    *tabs, seed[:n])
    for a, b in zip(full[:3], part[:3]):
        assert torch.equal(a[:n], b)
    assert int(part[3].sum()) == int(part[2].sum())
    ref = RK.closest_rank_ref(o[:n], d[:n], m[:n], [k1[:n], k2[:n]], *tabs,
                              seed[:n])
    assert torch.equal(part[0], ref[0]) and torch.equal(part[1], ref[1])


@pytest.mark.parametrize("seeded", [True, False])
def test_warp_model_gives_the_rank_walks_keys(setup, seeded):
    """The warp's grouped leaf service (``serve_closest``) on the walk's
    rounds gives its keys exactly, on 333 rays (a partial last warp)."""
    _, _, tdata, tspec, passes = setup
    (o, d, m), seed, (k1, k2, _) = passes[1]
    n = 333
    o, d, m, k1, k2, seed = (x[:n] for x in (o, d, m, k1, k2, seed))
    bvh = tspec.bvh
    rounds = []
    key, base, visits, _ = RK.closest_rank_walk_ref(
        o, d, m, [k1, k2], tdata.tri_planes, bvh, seed if seeded else None,
        rounds=rounds)
    assert len(rounds) == 2 and int(visits.sum()) > 0
    mseed = seed.numpy() if seeded else np.full(n, TC._INIT_KEY, np.int32)
    mbase = None if seeded else np.zeros(n, np.int32)
    mt, mtri, steps = model_closest(
        o.numpy(), d.numpy(), m.numpy(), mseed, mbase,
        tdata.tri_planes.numpy(), bvh, [r.numpy() for r in rounds])
    np.testing.assert_array_equal(mtri, decode_key(key, base))
    np.testing.assert_array_equal(mt.view(np.int32),
                                  TC._key_to_t(key).numpy().view(np.int32))
    assert steps == int(visits.sum()) * -(-bvh.cluster_size // STEP)
