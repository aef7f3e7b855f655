"""The rank-directed closest walk's (K6) certificate against the JAX
package's, its wrapper on the CPU (the plain version, no launch counted) and
the argument errors of it and of the hierarchical wrapper's seed base; and a
numpy model of K5's branch-free top-2 update against the plain version of
the fused broad phase (``broadphase_ref``), bit for bit.  Set-up:
coatball 64x48's recorded closest passes with their rank keys
(``torch_port_common.rank_setup``), as in ``tests/test_torch_rank.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import rank_cuda as RK
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (few_torch_threads,  # noqa: F401
                               rank_bounce1, rank_setup, rank_walks)


@pytest.fixture(scope="module")
def setup():
    """(JAX data, JAX spec, port data, port spec, passes) on coatball;
    each pass is ((o, d, mask), seed key, rank keys 1..3)."""
    return rank_setup()


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
    _, _, tdata, tspec, (o, d, m), seed, (k1, k2, _) = rank_bounce1(setup)
    key, base, _, _ = rank_walks(1)
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
    _, _, tdata, tspec, (o, d, m), seed, (k1, k2, _) = rank_bounce1(setup)
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
