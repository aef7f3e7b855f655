"""The launch counts of the hierarchical kernels' wide instances
(``trace_closest.launches_wide``, ``trace_any.launches_wide``): the reset
zeroes them, the CPU path leaves them as they were on tables whose supers
hold more than ``SHARED_PER_SUPER`` clusters, and a scene of 4,800
clusters takes supers of 40, the wide instances' side of that limit."""

import numpy as np
import torch

from metal_raytracing_tpu_torch import accel
from metal_raytracing_tpu_torch.ops import trace_cuda as TC


def wide_counts():
    return TC.trace_closest.launches_wide, TC.trace_any.launches_wide


def test_reset_zeroes_the_wide_counts():
    TC.trace_closest.launches_wide, TC.trace_any.launches_wide = 3, 2
    TC.reset_launch_counts()
    assert wide_counts() == (0, 0)


def test_the_cpu_path_leaves_the_wide_counts_unchanged():
    # 4,200 one-triangle clusters (the quick morton build): supers of 40
    rng = np.random.default_rng(0)
    n = 4200
    v0 = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    e1, e2 = (rng.normal(0.0, 0.05, (n, 3)).astype(np.float32)
              for _ in range(2))
    order, lo, hi, spec = accel.build_cluster_bvh(v0, e1, e2, cluster_size=1,
                                                  builder="morton")

    def slots(a):
        return torch.from_numpy(np.where((order >= 0)[:, None],
                                         a[order.clip(0)], 0.0))

    sup, clu, tri = TC.pack_scene_planes(slots(v0), slots(e1), slots(e2),
                                         torch.from_numpy(lo),
                                         torch.from_numpy(hi), spec)
    assert clu.shape[1] > TC.SHARED_PER_SUPER
    rays = 256
    o = torch.zeros((rays, 3))
    o[:, 2] = -3.0
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(0.0, 0.2, (rays, 3)).astype(np.float32))
        + torch.tensor([0.0, 0.0, 1.0]), dim=1)
    mask = torch.ones(rays, dtype=torch.bool)
    before = wide_counts()
    hit = TC.trace_closest(o, d, mask, sup, clu, tri, spec, flat=False)
    occ = TC.trace_any(o, d, torch.full((rays,), 6.0), mask, sup, clu, tri,
                       spec, flat=False)
    assert bool((hit.tri >= 0).any()) and bool(occ.any())
    assert wide_counts() == before


def test_a_4800_cluster_scene_takes_supers_of_40():
    spec = accel.BVHSpec(num_triangles=4800 * 384,
                         padded_triangles=4800 * 384, cluster_size=384,
                         num_clusters=4800, branching=8, levels=5,
                         num_nodes=4800, first_leaf=0)
    s, ns = TC.super_layout(spec)
    assert (s, ns) == (40, 120) and s > TC.SHARED_PER_SUPER
