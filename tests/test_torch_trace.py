"""The plain versions of the port's flat kernels (K1 closest, K2 any hit)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

Both sides see the same scene planes (one JAX build, carried across with
``scene_data_from_reference``) and the same rays: coatball's primary pass and
its bounce-1 pass at 64x48, recorded from the port's renderer
(``torch_port_common.coatball_passes``).  The global set's own tests are in
``tests/test_torch_global_set.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (MIN_MATCH, NEAR_TIE_REL, assert_near_ties,
                               coatball_passes,
                               few_torch_threads,  # noqa: F401
                               traversal_block)


@pytest.fixture(scope="module")
def setup():
    """(JAX data, JAX spec, port data, port spec, recorded passes)."""
    setup = coatball_passes()
    tspec = setup[3]
    assert TC._use_flat(tspec.bvh) and tspec.bvh.num_global > 0
    return setup


def _j(x):
    return jnp.asarray(x.numpy())


_CLOSEST = {}


def closest_pair(setup, bounce):
    """(live, port t, port tri, JAX t, JAX tri) of one recorded closest
    pass: the plain version against the interpret-mode Pallas kernel."""
    if bounce not in _CLOSEST:
        jdata, jspec, tdata, tspec, calls = setup
        o, d, m, seed = calls["closest"][bounce]
        ref = TP.trace_closest(_j(o), _j(d), _j(m), jdata.sup_planes,
                               jdata.clu_planes, jdata.tri_planes, jspec.bvh,
                               block=traversal_block(bounce),
                               seed_key=_j(seed),
                               exact_uv=False)
        t, tri = TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh,
                                     seed)
        _CLOSEST[bounce] = (m.numpy(), t.numpy(), tri.numpy(),
                            np.asarray(ref.t), np.asarray(ref.tri))
    return _CLOSEST[bounce]


@pytest.mark.parametrize("bounce", [0, 1])
def test_closest_plain_matches_pallas_kernel(setup, bounce):
    """Equal ids, or a near-tie: coatball's ball base has a bottom cap
    coplanar with the floor, and the interpret-mode kernel (whose XLA build
    fuses multiply-adds) can put the same t into the next 512-ulp bucket."""
    _, _, tdata, _, calls = setup
    o, d, _, _ = calls["closest"][bounce]
    live, t, tri, jt, jtri = closest_pair(setup, bounce)
    assert live.sum() > 0.9 * live.size
    same = (tri == jtri) & live
    assert_near_ties(o, d, tri, jtri, live, tdata.tri_planes)
    # Chopped t of the same winner: within the chop, plus 1e-4 absolute for
    # bounce rays that start 1e-3 off a surface, where n.v0 - n.o cancels
    # and the two builds' roundings move t by up to ~1e-5.
    both = same & (tri >= 0)
    np.testing.assert_allclose(t[both], jt[both], rtol=NEAR_TIE_REL,
                               atol=1e-4)
    np.testing.assert_array_equal(tri[~live], jtri[~live])


def test_closest_ids_agree_on_live_rays(setup):
    """Over the primary and the bounce-1 set together (6,144 live rays),
    ids agree on >= 99.9% (measured: 0 near-ties in the primary set, 5 in
    the bounce-1 set)."""
    n_live = n_same = 0
    for bounce in (0, 1):
        live, _, tri, _, jtri = closest_pair(setup, bounce)
        n_live += int(live.sum())
        n_same += int(((tri == jtri) & live).sum())
    assert n_same >= MIN_MATCH * n_live, (n_same, n_live)


@pytest.mark.parametrize("bounce", [0, 1])
def test_any_plain_matches_pallas_kernel(setup, bounce):
    jdata, jspec, tdata, tspec, calls = setup
    o, d, mt, m = calls["any"][bounce]
    ref = np.asarray(TP.trace_any(
        _j(o), _j(d), _j(mt), _j(m), jdata.sup_planes, jdata.clu_planes,
        jdata.tri_planes, jspec.bvh, block=traversal_block(bounce),
        seed_global=False))
    got = TC.any_flat_ref(o, d, mt, m, tdata.tri_planes, tspec.bvh).numpy()
    live = m.numpy()
    assert live.sum() > 0 and got[live].any()
    assert ((got == ref) | ~live).sum() >= MIN_MATCH * live.size
    assert not got[~live].any() and not ref[~live].any()


def test_wrappers_run_plain_versions_on_cpu(setup):
    _, _, tdata, tspec, calls = setup
    o, d, m, seed = calls["closest"][1]
    before = (TC.trace_closest.launches, TC.trace_any.launches)
    hit = TC.trace_closest(o, d, m, tdata.sup_planes, tdata.clu_planes,
                           tdata.tri_planes, tspec.bvh, seed)
    t, tri = TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh, seed)
    assert torch.equal(hit.tri, tri) and torch.equal(hit.t, t)
    o2, d2, mt2, m2 = calls["any"][1]
    occ = TC.trace_any(o2, d2, mt2, m2, tdata.sup_planes, tdata.clu_planes,
                       tdata.tri_planes, tspec.bvh)
    assert torch.equal(occ, TC.any_flat_ref(o2, d2, mt2, m2,
                                            tdata.tri_planes, tspec.bvh))
    # the counts grow only where a kernel launches
    assert (TC.trace_closest.launches, TC.trace_any.launches) == before
    with pytest.raises(ValueError, match="seed_key"):
        TC.trace_closest(o, d, m, tdata.sup_planes, tdata.clu_planes,
                         tdata.tri_planes, tspec.bvh, seed.to(torch.int64))


def test_flat_switch_and_layout_match_reference(setup):
    _, jspec, _, tspec, _ = setup
    assert TC.super_layout(tspec.bvh) == TP.super_layout(jspec.bvh)
    assert TC._use_flat(tspec.bvh) == TP._use_flat(jspec.bvh, None)
    big = dataclasses.replace(tspec.bvh, num_clusters=344)
    assert not TC._use_flat(big)
    assert not TP._use_flat(dataclasses.replace(jspec.bvh, num_clusters=344),
                            None)
    assert (TC.IDX_MASK, TC._MISS_KEY, TC._INIT_KEY) == (
        TP.IDX_MASK, TP._MISS_KEY, TP._INIT_KEY)


def test_hierarchical_scene_takes_hierarchical_route(setup):
    """A scene past 128 padded clusters (dragon: 344 clusters, 43 supers of
    8) takes the hierarchical kernels K3/K4; ``flat=`` overrides the
    choice, as in the JAX wrappers."""
    _, _, tdata, tspec, _ = setup
    big = dataclasses.replace(tspec.bvh, num_clusters=344)
    s_per, ns = TC.super_layout(big)
    sup = torch.zeros((48, 6))
    clu = torch.zeros((ns, s_per, 6))
    tri = torch.zeros((12, ns * s_per * big.cluster_size + 128))
    hier, sup_c, clu_c, tri_c = TC._kernel_tables(big, sup, clu, tri)
    assert hier and sup_c.shape == (43, 6) and clu_c.shape == (43, 8, 6)
    assert not TC._kernel_tables(tspec.bvh, tdata.sup_planes,
                                 tdata.clu_planes, tdata.tri_planes)[0]
    assert TC._kernel_tables(tspec.bvh, tdata.sup_planes, tdata.clu_planes,
                             tdata.tri_planes, flat=False)[0]
    with pytest.raises(ValueError, match="flat kernels"):
        TC._kernel_tables(big, sup, clu, tri, flat=True)
