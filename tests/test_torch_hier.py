"""The plain versions of the hierarchical kernels (K3 closest, K4 any hit)
and of the fused broad phase (K5) against the JAX package's Pallas kernels,
run in interpret mode on the CPU.

Coatball at 64x48 has 37 clusters, 5 supers of 8; ``flat=False`` forces the
hierarchical kernels on it, as ``tests/test_trace_pallas.py`` does.  Both
sides see the same scene planes (one JAX build carried across) and the same
rays, recorded from the port's renderer: the primary, bounce-1 and shadow
passes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (MIN_MATCH, NEAR_TIE_REL, assert_near_ties,
                               build_both, few_torch_threads,  # noqa: F401
                               record_passes)

W, H = 64, 48
# A broad-phase cluster key mismatch must come from a 1-ulp entry-t
# difference (trace_pallas.py:1006-1009): the two keys' t parts at most one
# chop step (2^12 in the key's bits) apart.  The global seed keys chop at
# 2^9; the interpret-mode kernel takes their t through an approximate
# reciprocal whose Newton step leaves 2^-16 relative error, which drops
# a few percent of them one chop step lower, so they are held to one step
# there and to >= MIN_MATCH equality with the port's exact-divide seed.
NC_STEP = 1 << 12
SEED_STEP = 1 << 9


@pytest.fixture(scope="module")
def setup():
    """(JAX data, JAX spec, port data, port spec, recorded passes)."""
    jdata, jspec, tdata, tspec = build_both("coatball", W, H)
    assert TC.super_layout(tspec.bvh) == (8, 5)
    assert TC._use_flat(tspec.bvh) and tspec.bvh.num_global > 0
    calls = record_passes(tdata, tspec, RenderConfig(width=W, height=H))
    return jdata, jspec, tdata, tspec, calls


def _j(x):
    return jnp.asarray(x.numpy())


def _block(bounce):
    """The renderer's traversal block: primary passes use 512."""
    return 512 if bounce == 0 else 128


_CLOSEST = {}


def closest_pair(setup, bounce):
    """(live, port t, port tri, JAX t, JAX tri) of one recorded closest
    pass: the plain version against the interpret-mode K3."""
    if bounce not in _CLOSEST:
        jdata, jspec, tdata, tspec, calls = setup
        o, d, m, seed = calls["closest"][bounce]
        ref = TP.trace_closest(_j(o), _j(d), _j(m), jdata.sup_planes,
                               jdata.clu_planes, jdata.tri_planes, jspec.bvh,
                               block=_block(bounce), seed_key=_j(seed),
                               exact_uv=False, flat=False)
        t, tri = TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh,
                                     seed)
        _CLOSEST[bounce] = (m.numpy(), t.numpy(), tri.numpy(),
                            np.asarray(ref.t), np.asarray(ref.tri))
    return _CLOSEST[bounce]


@pytest.mark.parametrize("bounce", [0, 1])
def test_closest_plain_matches_hierarchical_kernel(setup, bounce):
    _, _, tdata, _, calls = setup
    o, d, _, _ = calls["closest"][bounce]
    live, t, tri, jt, jtri = closest_pair(setup, bounce)
    assert live.sum() > 0.9 * live.size
    assert_near_ties(o, d, tri, jtri, live, tdata.tri_planes)
    # chopped t of the same winner: within the chop, plus 1e-4 absolute for
    # bounce rays that start 1e-3 off a surface (see test_torch_trace.py)
    both = live & (tri == jtri) & (tri >= 0)
    np.testing.assert_allclose(t[both], jt[both], rtol=NEAR_TIE_REL,
                               atol=1e-4)
    np.testing.assert_array_equal(tri[~live], jtri[~live])


def test_closest_hierarchical_ids_agree_on_live_rays(setup):
    n_live = n_same = 0
    for bounce in (0, 1):
        live, _, tri, _, jtri = closest_pair(setup, bounce)
        n_live += int(live.sum())
        n_same += int(((tri == jtri) & live).sum())
    assert n_same >= MIN_MATCH * n_live, (n_same, n_live)


@pytest.mark.parametrize("bounce", [0, 1])
def test_any_plain_matches_hierarchical_kernel(setup, bounce):
    jdata, jspec, tdata, tspec, calls = setup
    o, d, mt, m = calls["any"][bounce]
    ref = np.asarray(TP.trace_any(
        _j(o), _j(d), _j(mt), _j(m), jdata.sup_planes, jdata.clu_planes,
        jdata.tri_planes, jspec.bvh, block=_block(bounce), flat=False,
        seed_global=False))
    got = TC.any_flat_ref(o, d, mt, m, tdata.tri_planes, tspec.bvh).numpy()
    live = m.numpy()
    assert live.sum() > 0 and got[live].any()
    assert ((got == ref) & live).sum() >= MIN_MATCH * live.sum()
    assert not got[~live].any() and not ref[~live].any()


# (pass, bounce, want2, with_clusters, any_mode) per broad-phase mode
MODES = {
    "keys": ("closest", 0, False, True, False),
    "keys2_shadow": ("any", 0, True, True, True),
    "closest_global": ("closest", 1, False, False, False),
    "any_global": ("any", 1, False, False, True),
}


def _t_part(key, step):
    return key.astype(np.int64) & ~(step - 1)


def _assert_keys_close(got, ref, live, step):
    """Equal on >= MIN_MATCH of live rays; a mismatch only where the t parts
    are one chop step apart (a 1-ulp entry-t difference)."""
    same = (got == ref) | ~live
    assert same.sum() - (~live).sum() >= MIN_MATCH * live.sum()
    off = np.abs(_t_part(got, step) - _t_part(ref, step))[~same]
    assert (off <= step).all(), off.max()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_broadphase_plain_matches_kernel(setup, mode):
    jdata, jspec, tdata, tspec, calls = setup
    kind, bounce, want2, with_clusters, any_mode = MODES[mode]
    rays = calls[kind][bounce]
    if kind == "any":
        o, d, mt, m = rays
    else:
        (o, d, m, _), mt = rays, None
    ref = TP.broadphase_keys(
        _j(o), _j(d), _j(m), jdata.clu_planes, jdata.tri_planes, jspec.bvh,
        max_t=None if mt is None else _j(mt), want2=want2,
        with_clusters=with_clusters, any_mode=any_mode)
    got = BP.broadphase_ref(o, d, m, tdata.clu_planes, tdata.tri_planes,
                            tspec.bvh, max_t=mt, want2=want2,
                            with_clusters=with_clusters, any_mode=any_mode)
    live = m.numpy()
    assert live.sum() > 0
    for name, g, r in zip(("key1", "key2", "g"), got, ref):
        assert (g is None) == (r is None), name
        if g is None:
            continue
        g, r = g.numpy(), np.asarray(r)
        if name == "g" and any_mode:
            assert ((g == r) & live).sum() >= MIN_MATCH * live.sum()
            assert not g[~live].any()
        elif name == "g":
            off = np.abs(_t_part(g, SEED_STEP) - _t_part(r, SEED_STEP))
            assert (off <= SEED_STEP).all()
            assert ((g & 0x1FF) == (r & 0x1FF)).all()
            exact = TC.global_seed_keys(o, d, m, tdata.tri_planes,
                                        tspec.bvh).numpy()
            assert ((g == exact) & live).sum() >= MIN_MATCH * live.sum()
            np.testing.assert_array_equal(g[~live], r[~live])
        else:
            _assert_keys_close(g, r, live, NC_STEP)
            np.testing.assert_array_equal(g[~live], r[~live])
    if with_clusters:
        key1 = got[0]
        assert (key1[torch.from_numpy(live)] != BP.NC_SENT).any()
        ncp = tdata.clu_planes.shape[0] * tdata.clu_planes.shape[1]
        np.testing.assert_array_equal(
            BP.decode_cluster_key(key1, ncp).numpy(),
            np.asarray(TP.decode_cluster_key(_j(key1), ncp)))


def test_broadphase_wrapper_runs_plain_version_on_cpu(setup):
    _, _, tdata, tspec, calls = setup
    o, d, mt, m = calls["any"][0]
    counts = lambda: (BP.broadphase_keys.launches,
                      BP.broadphase_keys.launches_clusters)
    before = counts()
    got = BP.broadphase_keys(o, d, m, tdata.clu_planes, tdata.tri_planes,
                             tspec.bvh, max_t=mt, want2=True, any_mode=True)
    ref = BP.broadphase_ref(o, d, m, tdata.clu_planes, tdata.tri_planes,
                            tspec.bvh, max_t=mt, want2=True, any_mode=True)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert counts() == before
    assert BP.NC_SENT == TP._NC_SENT
    with pytest.raises(ValueError, match="max_t"):
        BP.broadphase_keys(o, d, m, tdata.clu_planes, tdata.tri_planes,
                           tspec.bvh, any_mode=True)


def test_hierarchical_wrappers_run_plain_versions_on_cpu(setup):
    _, _, tdata, tspec, calls = setup
    o, d, m, seed = calls["closest"][1]
    before = (TC.trace_closest.launches_hier, TC.trace_any.launches_hier)
    hit = TC.trace_closest(o, d, m, tdata.sup_planes, tdata.clu_planes,
                           tdata.tri_planes, tspec.bvh, seed, flat=False)
    t, tri = TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh, seed)
    assert torch.equal(hit.tri, tri) and torch.equal(hit.t, t)
    o2, d2, mt2, m2 = calls["any"][1]
    occ = TC.trace_any(o2, d2, mt2, m2, tdata.sup_planes, tdata.clu_planes,
                       tdata.tri_planes, tspec.bvh, flat=False)
    assert torch.equal(occ, TC.any_flat_ref(o2, d2, mt2, m2,
                                            tdata.tri_planes, tspec.bvh))
    assert (TC.trace_closest.launches_hier,
            TC.trace_any.launches_hier) == before


def test_super_layout_of_a_dragon_sized_scene(setup):
    _, jspec, _, tspec, _ = setup
    big = dataclasses.replace(tspec.bvh, num_clusters=344)
    jbig = dataclasses.replace(jspec.bvh, num_clusters=344)
    assert TC.super_layout(big) == TP.super_layout(jbig) == (8, 43)
    assert not TC._use_flat(big) and TC._use_flat(big, True)


def test_build_compiles_every_kernel_source(tmp_path, monkeypatch):
    """One library from every ``csrc/*.cu``, keyed by the sources, the
    shared header and the flags; without nvcc the first launch raises."""
    from metal_raytracing_tpu_torch.ops import _build

    names = [p.rsplit("/", 1)[-1] for p in _build.sources()]
    assert names == ["broadphase.cu", "trace_bvh.cu", "trace_flat.cu",
                     "trace_hier.cu", "trace_rank.cu"]
    path = _build._library_path()
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
