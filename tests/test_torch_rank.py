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
``test_torch_compaction_keys_*.py``).

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
from metal_raytracing_tpu_torch.ops import rank_cuda as RK
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (MIN_MATCH, NEAR_TIE_REL, assert_near_ties,
                               decode_key, few_torch_threads,  # noqa: F401
                               rank_bounce1, rank_setup, rank_walks)


@pytest.fixture(scope="module")
def setup():
    """(JAX data, JAX spec, port data, port spec, passes) on coatball;
    each pass is ((o, d, mask), seed key, rank keys 1..3)."""
    return rank_setup()


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("bounce", [0, 1, 2])
def test_rank_walk_matches_kernel_on_certified_rays(setup, bounce):
    tdata = setup[2]
    (o, d, m), _, (_, _, k3) = setup[4][bounce]
    key, base, jkey, jbase = rank_walks(bounce)
    cert = (RK.rank_certificate(key, k3) & m).numpy()
    assert cert.sum() > 0.5 * int(m.sum())
    tri, jtri = decode_key(key, base), decode_key(jkey, jbase)
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
        key, base, jkey, jbase = rank_walks(bounce)
        cert = (RK.rank_certificate(key, k3) & m).numpy()
        n_cert += int(cert.sum())
        n_same += int(((decode_key(key, base) == decode_key(jkey, jbase))
                       & cert).sum())
    assert n_same >= MIN_MATCH * n_cert, (n_same, n_cert)


@pytest.mark.parametrize("bounce", [1, 2])
def test_rank_walk_key_is_not_below_the_kernels(setup, bounce):
    """The TPU lane sees a superset of the port ray's clusters."""
    (_, _, m), _, _ = setup[4][bounce]
    key, _, jkey, _ = rank_walks(bounce)
    assert ((key >= jkey) & m).sum() >= MIN_MATCH * int(m.sum())
    # where it is below, then by the rounding of a contracted t
    below = ((key < jkey) & m).numpy()
    np.testing.assert_allclose(TC._key_to_t(key).numpy()[below],
                               TC._key_to_t(jkey).numpy()[below],
                               rtol=NEAR_TIE_REL, atol=1e-4)
    # and the superset shows: some ray got a nearer hit over there
    assert ((jkey < key) & m).any()


def test_rank_walk_leaves_masked_rays_at_their_seed(setup):
    _, _, tdata, tspec, (o, d, m), seed, (k1, k2, _) = rank_bounce1(setup)
    key, base, _, _ = rank_walks(1)
    assert torch.equal(key[~m], seed[~m])
    assert (base[~m] == tspec.bvh.global_base).all()
    # no seed: the init key with base 0, as the TPU kernel
    nokey, nobase = RK.closest_rank_ref(o, d, torch.zeros_like(m), [k1, k2],
                                        tdata.tri_planes, tspec.bvh)
    assert (nokey == TC._INIT_KEY).all() and (nobase == 0).all()


def test_walk_certificate_and_fallback_equal_the_full_walk(setup):
    _, _, tdata, tspec, (o, d, m), seed, (_, _, k3) = rank_bounce1(setup)
    key, base, _, _ = rank_walks(1)
    bvh = tspec.bvh
    unresolved = m & ~RK.rank_certificate(key, k3)
    assert 0 < int(unresolved.sum()) < 0.5 * int(m.sum())
    fb = TC.trace_closest(o, d, unresolved, tdata.sup_planes,
                          tdata.clu_planes, tdata.tri_planes, bvh, key,
                          flat=False, seed_base=base)
    tri = np.where(unresolved.numpy(), fb.tri.numpy(), decode_key(key, base))
    ref = TC.trace_closest(o, d, m, tdata.sup_planes, tdata.clu_planes,
                           tdata.tri_planes, bvh, seed)
    live = m.numpy()
    assert ((tri == ref.tri.numpy()) & live).sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri, ref.tri.numpy(), live, tdata.tri_planes)


def test_seed_base_plain_matches_hierarchical_kernel(setup):
    """``closest_flat_ref`` seeded per ray with the walk's key and base
    against the interpret-mode K3 with ``seed_base``."""
    jdata, jspec, tdata, tspec, (o, d, m), _, _ = rank_bounce1(setup)
    key, base, _, _ = rank_walks(1)
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
