"""The plain version of the fused broad phase (K5, ``broadphase_ref``)
against the JAX package's ``broadphase_keys`` in its four modes, and its
wrapper on the CPU (the plain version, no launch counted).

Coatball at 64x48 (37 clusters, 5 supers of 8): both sides see the same
scene planes (one JAX build carried across) and the same rays, recorded
from the port's renderer (``torch_port_common.coatball_passes``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (MIN_MATCH, coatball_passes,
                               few_torch_threads)  # noqa: F401

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
    setup = coatball_passes()
    tspec = setup[3]
    assert TC.super_layout(tspec.bvh) == (8, 5)
    assert TC._use_flat(tspec.bvh) and tspec.bvh.num_global > 0
    return setup


def _j(x):
    return jnp.asarray(x.numpy())


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
