"""``nearest_cluster_kernel`` on dragon 1024x1024's primary and bounce-1 passes
on the card: ray counts that fill no block of the kernel (and ``n = 0``)
against the plain chain, with the launches they take; ranks 1-2 against K5's
cluster keys (``broadphase_kernel``).  On the CPU every case skips.
The file imports no JAX, so it runs on the card:
``python -m pytest --noconftest tests/test_torch_exact_broadphase_*.py``."""

import pytest
import torch

from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import card, card_scene_rays, equal_forms


@pytest.fixture(scope="module")
def scene_rays():
    """scene -> (clu, sup, [primary rays, bounce-1 rays], tri, bvh) on the
    card."""
    return card_scene_rays()


@pytest.mark.parametrize("n", [0, 1, 31, 1025, 1_000_003])
def test_kernel_ragged_and_empty_counts(scene_rays, n, monkeypatch):
    """Counts that fill no block of the kernel (and none at all)."""
    clu, sup, passes = scene_rays["dragon"][:3]
    closest_rays, shadow_rays = passes[0]
    TC.reset_launch_counts()
    for form in ("third_packed", "segment_second", "pair3_packed"):
        rays = shadow_rays if form[0] in "sp" else closest_rays
        got = equal_forms(form, tuple(x[:n] for x in rays), clu, sup,
                          monkeypatch)
        assert all(g.shape == (n,) for g in got)
    launched = int(n > 0)
    assert BP.nearest_cluster.launches == 2 * launched
    assert BP.nearest_cluster.launches_pair == launched


def test_kernel_ranks_equal_k5_keys(scene_rays):
    """Ranks 1-2 against K5's cluster keys (``broadphase_kernel`` in its
    keys+second mode) on dragon's primary and bounce-1 rays."""
    card()
    clu, _, passes, tri, bvh = scene_rays["dragon"]
    for (o, d, m, *_), _ in passes:
        _, k1, k2 = BP.nearest_cluster(o, d, m, clu, bvh, return_key=True,
                                       return_second=1, return_packed=True)
        f1, f2, _ = BP.broadphase_keys(o, d, m, clu, tri, bvh, want2=True)
        assert torch.equal(k1, f1) and torch.equal(k2, f2)
