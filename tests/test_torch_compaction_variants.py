"""Dragon's other compaction configs on the CPU (32x24, one port sample
each, all through one per-ray memo of the plain tracers,
``torch_port_common.compaction_render``): each config's image within 1e-6
of the ``compaction=True`` image per pixel, with equal ray counts; the rank
walk's fallback takes a minority of the sorted bounce rays.  A traced ray's
result depends only on the ray, so the memo gives every config the same
bits, and the tests catch faults of the renderer (a fold, mask, seed or
permutation), not of the tracers."""

import numpy as np
import pytest

from torch_port_common import (compaction_render,
                               few_torch_threads)  # noqa: F401


@pytest.fixture(scope="module")
def renders():
    """``render(scene, **config) -> (image, stats)``: one port sample of
    ``scene`` at the given config, each config rendered once per test run;
    coatball on the plain tracers, all of dragon's configs through one
    :class:`MemoTracers`."""
    return compaction_render


# dragon's other compaction configs, each held to the compaction=True image
VARIANTS = {
    "rank_trace": dict(rank_trace=2),
    "fused_broadphase": dict(fused_broadphase=True),
    "no_pair": dict(pair_broadphase=False),
    "rank_trace_no_pair": dict(rank_trace=2, pair_broadphase=False),
    # the walk off behind K5's keys (they carry no third rank)
    "rank_trace_fused": dict(rank_trace=2, fused_broadphase=True),
    "partition_only": dict(sort_bounces=False),
    "no_miss_fold": dict(cluster_miss_fold=False),
    "no_shadow_sort": dict(shadow_sort=False),
    # the walk with the pair sweep off: its keys from a sweep of their own
    "rank_trace_no_shadow_sort": dict(rank_trace=2, shadow_sort=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dragon_compaction_variants_give_the_same_image(renders, variant):
    ref, ref_stats = renders("dragon", compaction=True)
    img, stats = renders("dragon", compaction=True, **VARIANTS[variant])
    np.testing.assert_allclose(img, ref, atol=1e-6)
    assert stats["closest_rays"] == ref_stats["closest_rays"]
    assert stats["shadow_rays"] == ref_stats["shadow_rays"]
    kw = VARIANTS[variant]
    walked = "rank_unresolved_b1" in stats
    assert walked == (kw.get("rank_trace", 0) == 2
                      and not kw.get("fused_broadphase", False))
    if walked:
        # the fallback takes a minority of the sorted bounce rays
        for b in (1, 2):
            assert 0 <= stats[f"rank_unresolved_b{b}"] < 0.2 * 32 * 24
