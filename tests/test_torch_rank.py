"""The rank-directed closest walk (K6) and the per-ray seed base of the
hierarchical walk (K3) against the JAX package's Pallas kernels, run in
interpret mode on the CPU.

Coatball at 64x48 has 37 clusters in 5 supers of 8; its tables serve the
rank kernel as they are (it walks candidate clusters, not supers), and
``flat=False`` forces the hierarchical kernel for the fallback.  Both sides
see the same scene planes (one JAX build carried across), the same rays
(the closest passes of one port sample: primary, bounce 1, bounce 2, the
scene and the pixel offsets made from seeds with numpy), and the same
candidate keys (the two packages' broad phases agree bit for bit,
``test_torch_compaction.py``).

The TPU kernel dense-tests every cluster it pops against all 128 rays of a
tile, so a lane also sees clusters only its neighbours asked for; the port
walks each ray's own two candidates.  What carries over, and what these
tests hold:

- on the rays the certificate accepts the two agree: ids equal on >= 99.9%
  over the three passes together, any other a near-tie (exact t within
  2^-13 relative).  Coatball's bottom cap is coplanar with the floor, and
  the interpret-mode kernel (whose XLA build fuses multiply-adds) can put
  the same t into the next 512-ulp bucket: measured 0 such rays in the
  primary pass, 3 in bounce 1, 2 in bounce 2;
- on every live ray the port's key is not below the TPU kernel's, up to the
  rounding of t (interpret mode contracts multiply-adds that the port
  rounds op by op: the chopped t of one hit agrees within 2^-13 relative
  plus 1e-4 absolute, the tolerance of ``test_torch_trace.py``);
- walk, certificate and seeded fallback together equal the full closest
  walk on every ray, near-ties allowed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import rank_cuda as RK
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (MIN_MATCH, NEAR_TIE_REL, STEP, WARP,
                               assert_near_ties, build_both,
                               few_torch_threads,  # noqa: F401
                               model_closest, record_passes)

W, H = 64, 48


@pytest.fixture(scope="module")
def setup():
    """(JAX data, JAX spec, port data, port spec, passes) on coatball;
    each pass is ((o, d, mask), seed key, rank keys 1..3)."""
    jdata, jspec, tdata, tspec = build_both("coatball", W, H)
    assert tspec.bvh.num_global > 0
    calls = record_passes(tdata, tspec, RenderConfig(width=W, height=H))
    passes = []
    for o, d, m, seed in calls["closest"]:
        _, k1, k2, k3 = BP.nearest_cluster(
            o, d, m, tdata.clu_planes, tspec.bvh, return_key=True,
            return_second=2, return_packed=True)
        passes.append(((o, d, m), seed, (k1, k2, k3)))
    assert len(passes) == 3
    return jdata, jspec, tdata, tspec, passes


def bounce1(setup):
    """(JAX data, JAX spec, port data, port spec, rays, seed, rank keys) of
    the bounce-1 pass."""
    return setup[:4] + setup[4][1]


def _j(x):
    return jnp.asarray(x.numpy())


def _decode(key, base):
    found = key < TC._MISS_KEY
    return torch.where(found, base + (key & TC.IDX_MASK), -1).numpy()


_WALK = {}


def walks(setup, bounce=1):
    """(port key, port base, TPU key, TPU base) of one pass's rank walk,
    each computed once."""
    if bounce not in _WALK:
        jdata, jspec, tdata, tspec, passes = setup
        (o, d, m), seed, (k1, k2, _) = passes[bounce]
        key, base = RK.closest_rank_ref(o, d, m, [k1, k2], tdata.tri_planes,
                                        tspec.bvh, seed)
        jkey, jbase = TP.trace_closest_rank(
            _j(o), _j(d), _j(m), [_j(k1), _j(k2)], jdata.tri_planes,
            jspec.bvh, seed_key=_j(seed))
        _WALK[bounce] = (key, base, torch.from_numpy(np.array(jkey)),
                         torch.from_numpy(np.array(jbase)))
    return _WALK[bounce]


@pytest.mark.parametrize("bounce", [0, 1, 2])
def test_rank_walk_matches_kernel_on_certified_rays(setup, bounce):
    tdata = setup[2]
    (o, d, m), _, (_, _, k3) = setup[4][bounce]
    key, base, jkey, jbase = walks(setup, bounce)
    cert = (RK.rank_certificate(key, k3) & m).numpy()
    assert cert.sum() > 0.5 * int(m.sum())
    tri, jtri = _decode(key, base), _decode(jkey, jbase)
    assert_near_ties(o, d, tri, jtri, cert, tdata.tri_planes)
    # the chopped t of the same winner: within the chop, plus 1e-4 absolute
    # for bounce rays that start 1e-3 off a surface (test_torch_trace.py)
    same = cert & (tri == jtri) & (tri >= 0)
    np.testing.assert_allclose(TC._key_to_t(key).numpy()[same],
                               TC._key_to_t(jkey).numpy()[same],
                               rtol=NEAR_TIE_REL, atol=1e-4)
    np.testing.assert_array_equal(key[~m].numpy(), jkey[~m].numpy())


def test_rank_walk_ids_agree_on_certified_rays(setup):
    n_cert = n_same = 0
    for bounce in (0, 1, 2):
        (_, _, m), _, (_, _, k3) = setup[4][bounce]
        key, base, jkey, jbase = walks(setup, bounce)
        cert = (RK.rank_certificate(key, k3) & m).numpy()
        n_cert += int(cert.sum())
        n_same += int(((_decode(key, base) == _decode(jkey, jbase))
                       & cert).sum())
    assert n_same >= MIN_MATCH * n_cert, (n_same, n_cert)


@pytest.mark.parametrize("bounce", [1, 2])
def test_rank_walk_key_is_not_below_the_kernels(setup, bounce):
    """The TPU lane sees a superset of the port ray's clusters."""
    (_, _, m), _, _ = setup[4][bounce]
    key, _, jkey, _ = walks(setup, bounce)
    assert ((key >= jkey) & m).sum() >= MIN_MATCH * int(m.sum())
    # where it is below, then by the rounding of a contracted t
    below = ((key < jkey) & m).numpy()
    np.testing.assert_allclose(TC._key_to_t(key).numpy()[below],
                               TC._key_to_t(jkey).numpy()[below],
                               rtol=NEAR_TIE_REL, atol=1e-4)
    # and the superset shows: some ray got a nearer hit over there
    assert ((jkey < key) & m).any()


def test_rank_walk_leaves_masked_rays_at_their_seed(setup):
    _, _, tdata, tspec, (o, d, m), seed, (k1, k2, _) = bounce1(setup)
    key, base, _, _ = walks(setup)
    assert torch.equal(key[~m], seed[~m])
    assert (base[~m] == tspec.bvh.global_base).all()
    # no seed: the init key with base 0, as the TPU kernel
    nokey, nobase = RK.closest_rank_ref(o, d, torch.zeros_like(m), [k1, k2],
                                        tdata.tri_planes, tspec.bvh)
    assert (nokey == TC._INIT_KEY).all() and (nobase == 0).all()


def test_walk_certificate_and_fallback_equal_the_full_walk(setup):
    _, _, tdata, tspec, (o, d, m), seed, (_, _, k3) = bounce1(setup)
    key, base, _, _ = walks(setup)
    bvh = tspec.bvh
    unresolved = m & ~RK.rank_certificate(key, k3)
    assert 0 < int(unresolved.sum()) < 0.5 * int(m.sum())
    fb = TC.trace_closest(o, d, unresolved, tdata.sup_planes,
                          tdata.clu_planes, tdata.tri_planes, bvh, key,
                          flat=False, seed_base=base)
    tri = np.where(unresolved.numpy(), fb.tri.numpy(), _decode(key, base))
    ref = TC.trace_closest(o, d, m, tdata.sup_planes, tdata.clu_planes,
                           tdata.tri_planes, bvh, seed)
    live = m.numpy()
    assert ((tri == ref.tri.numpy()) & live).sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri, ref.tri.numpy(), live, tdata.tri_planes)


def test_seed_base_plain_matches_hierarchical_kernel(setup):
    """``closest_flat_ref`` seeded per ray with the walk's key and base
    against the interpret-mode K3 with ``seed_base``."""
    jdata, jspec, tdata, tspec, (o, d, m), _, _ = bounce1(setup)
    key, base, _, _ = walks(setup)
    ref = TP.trace_closest(_j(o), _j(d), _j(m), jdata.sup_planes,
                           jdata.clu_planes, jdata.tri_planes, jspec.bvh,
                           seed_key=_j(key), seed_base=_j(base),
                           exact_uv=False, flat=False)
    t, tri = TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh, key,
                                 base)
    live, tri, jtri = m.numpy(), tri.numpy(), np.asarray(ref.tri)
    assert ((tri == jtri) & live).sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri, jtri, live, tdata.tri_planes)
    both = live & (tri == jtri) & (tri >= 0)
    # the chopped t of the same winner: within the chop, plus 1e-4 absolute
    # for rays that start next to a surface (see test_torch_trace.py)
    np.testing.assert_allclose(t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=NEAR_TIE_REL, atol=1e-4)
    np.testing.assert_array_equal(tri[~live], jtri[~live])
    # a seed that the clusters do not beat keeps its own base
    kept = live & (t.numpy() == TC._key_to_t(key).numpy()) & (tri >= 0)
    assert kept.any()
    np.testing.assert_array_equal(
        tri[kept], (base + (key & TC.IDX_MASK)).numpy()[kept])


def test_rank_certificate_matches_reference():
    rng = np.random.RandomState(7)
    t = rng.uniform(0.0, 40.0, (4096,)).astype(np.float32)
    nxt = (t * rng.uniform(0.9, 1.1, t.shape)).astype(np.float32)
    key = (t.view(np.int32) & ~TC.IDX_MASK) | rng.randint(0, 384, t.shape)
    key = np.where(rng.rand(*t.shape) < 0.1, TC._INIT_KEY, key).astype(
        np.int32)
    nk = (nxt.view(np.int32) & ~BP.NC_IDM) | rng.randint(0, 344, t.shape)
    nk = np.where(rng.rand(*t.shape) < 0.1, BP.NC_SENT, nk).astype(np.int32)
    got = RK.rank_certificate(torch.from_numpy(key), torch.from_numpy(nk))
    ref = np.asarray(TP.rank_certificate(jnp.asarray(key), jnp.asarray(nk)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0.2 < got.float().mean() < 0.9


def test_rank_wrapper_runs_plain_version_on_cpu(setup):
    _, _, tdata, tspec, (o, d, m), seed, (k1, k2, _) = bounce1(setup)
    key, base, _, _ = walks(setup)
    before = RK.trace_closest_rank.launches
    got = RK.trace_closest_rank(o, d, m, [k1, k2], tdata.tri_planes,
                                tspec.bvh, seed)
    assert torch.equal(got[0], key) and torch.equal(got[1], base)
    assert RK.trace_closest_rank.launches == before
    # one candidate is a walk too: rank 1 only, so never a smaller key
    one, _ = RK.trace_closest_rank(o, d, m, [k1], tdata.tri_planes,
                                   tspec.bvh, seed)
    assert (one >= key).all() and (one > key).any()


def test_rank_and_seed_base_argument_errors(setup):
    _, _, tdata, tspec, (o, d, m), seed, (k1, k2, _) = bounce1(setup)
    tabs = (tdata.sup_planes, tdata.clu_planes, tdata.tri_planes, tspec.bvh)
    with pytest.raises(ValueError, match="global seed"):
        RK.trace_closest_rank(o, d, m, [k1, k2], tdata.tri_planes, tspec.bvh)
    with pytest.raises(ValueError, match="at least one"):
        RK.trace_closest_rank(o, d, m, [], tdata.tri_planes, tspec.bvh, seed)
    with pytest.raises(ValueError, match="rank_keys"):
        RK.trace_closest_rank(o, d, m, [k1, k2.long()], tdata.tri_planes,
                              tspec.bvh, seed)
    # as in the reference, the flat route takes no seed base
    with pytest.raises(ValueError, match="hierarchical"):
        TC.trace_closest(o, d, m, *tabs, seed, seed_base=k1)
    with pytest.raises(ValueError, match="seed_key"):
        TC.trace_closest(o, d, m, *tabs, flat=False, seed_base=k1)
    assert RK.NC_SENT == TP._NC_SENT and RK.NC_IDM == TP._NC_IDM


# ---------------------------------------------------------------------------
# The walk as the warps of closest_rank_kernel take it
# ---------------------------------------------------------------------------


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
    np.testing.assert_array_equal(mtri, _decode(key, base))
    np.testing.assert_array_equal(mt.view(np.int32),
                                  TC._key_to_t(key).numpy().view(np.int32))
    assert steps == int(visits.sum()) * -(-bvh.cluster_size // STEP)


# ---------------------------------------------------------------------------
# K5's branch-free top-2 update
# ---------------------------------------------------------------------------


def _top2_model(o, d, mask, boxes, max_t):
    """``broadphase_kernel``'s cluster sweep in float32 numpy: ``slab`` of
    ``csrc/trace_common.cuh`` op for op, box by box, each hit keyed
    ``(bits(entry) & ~0xFFF) | box`` (the sentinel on a miss) and folded in
    by ``k2 = min(k2, max(k1, key)); k1 = min(k1, key)``."""
    f = np.float32
    eps = f(1e-12)
    safe = np.where(np.abs(d) < eps, np.where(d < 0, -eps, eps), d)
    inv = f(1.0) / safe
    sent = np.int32(BP.NC_SENT)
    k1 = np.full(o.shape[0], sent)
    k2 = k1.copy()
    for c, box in enumerate(boxes):
        with np.errstate(over="ignore"):  # padding boxes span +-1e30
            t0, t1 = (box[:3] - o) * inv, (box[3:] - o) * inv
        lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
        tn = np.maximum(np.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        tf = np.minimum(np.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        hit = (tn <= tf) & (tf >= 0) & (tn <= max_t) & (box[3] >= box[0])
        entry = np.maximum(tn, f(0.0)).view(np.int32)
        key = np.where(hit, (entry & ~BP.NC_IDM) | c, sent).astype(np.int32)
        k2 = np.minimum(k2, np.maximum(k1, key))
        k1 = np.minimum(k1, key)
    return np.where(mask, k1, sent), np.where(mask, k2, sent)


@pytest.mark.parametrize("any_mode", [False, True])
def test_branch_free_top2_gives_the_broad_phase_keys(setup, any_mode):
    """Keys of one ray are distinct (their id bits differ), so the
    branch-free update keeps the two smallest: equal to the plain version's
    keys bit for bit, in both cluster modes (any mode bounds the slab test
    by max_t)."""
    _, _, tdata, tspec, passes = setup
    (o, d, m), _, _ = passes[1]
    clu = tdata.clu_planes
    rng = np.random.RandomState(5)
    max_t = torch.from_numpy(rng.uniform(0.05, 3.0, o.shape[0])
                             .astype(np.float32))
    kw = dict(max_t=max_t, any_mode=True) if any_mode else {}
    key1, key2, _ = BP.broadphase_ref(o, d, m, clu, tdata.tri_planes,
                                      tspec.bvh, want2=True, **kw)
    bound = max_t.numpy() if any_mode else np.float32(TC.BIG_T)
    k1, k2 = _top2_model(o.numpy(), d.numpy(), m.numpy(),
                         clu.reshape(-1, 6).numpy(), bound)
    np.testing.assert_array_equal(k1, key1.numpy())
    np.testing.assert_array_equal(k2, key2.numpy())
    live = m.numpy()
    assert (k2[live] != BP.NC_SENT).any() and (k2[live] == BP.NC_SENT).any()
    if any_mode:  # the bound cut some ray's nearest box
        free = _top2_model(o.numpy(), d.numpy(), live,
                           clu.reshape(-1, 6).numpy(), np.float32(TC.BIG_T))
        assert (free[0] != k1).any()
