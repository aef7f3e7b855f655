"""Traversal telemetry and the kernels' options in the port, on the CPU.

- ``RenderConfig(telemetry=True, export_rays=4)`` on dragon 16x16, two
  bounces (each bounce is one more JAX compile), at ``compaction=False``
  and at ``compaction=True, rank_trace=2``, against
  the JAX renderer's interpret-mode Pallas tracer on the same build:
  ``live_b``, ``shadow_b``, ``shadow_occn_b``, ``rank_unresolved_b`` and
  the ray counts equal; the exported rows have the JAX shapes and live
  columns, and at ``compaction=False`` their rays agree to 1e-4 (the port's
  rays are not the JAX rays bit for bit: XLA fuses the multiply-adds of ray
  generation and shading, eager PyTorch does not, as the images show); at
  ``compaction=True`` only shapes and invariants, since the unstable sort
  picks another strided subset; telemetry and export leave the image as it
  is;
- ``utils.metrics.visit_percentiles`` and ``wavefront_stats`` on those
  stats.

(``tests/test_torch_kernel_options.py`` holds the visits, the chunk skip,
the wide supers and ``utils.profiling``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu import renderer as JR
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu.utils import metrics as JM
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.types import RenderConfig
from metal_raytracing_tpu_torch.utils import metrics as TM
from torch_port_common import build_both, few_torch_threads  # noqa: F401

W, H = 16, 16
BOUNCES = 2
CONFIGS = {"compaction_false": dict(compaction=False),
           "compaction_true": dict(compaction=True, rank_trace=2)}
COUNTERS = ("closest_rays", "shadow_rays", "live_b", "shadow_b",
            "shadow_occn_b", "rank_unresolved_b")
STRIDE = 4  # export_rays


@pytest.fixture(scope="module")
def dragon():
    return build_both("dragon", W, H)


@pytest.fixture(scope="module")
def renders(dragon):
    """label -> (JAX stats as numpy, port image, port stats, port image
    without telemetry or export): one sample of each config."""
    jdata, jspec, tdata, tspec = dragon
    out = {}
    for label, kw in CONFIGS.items():
        jcfg = JConfig(width=W, height=H, tracer="pallas", telemetry=True,
                       export_rays=STRIDE, max_bounces=BOUNCES, **kw)
        _, jst = jax.jit(lambda d, o: JR.render_sample(
            d, jspec, jcfg, o, jnp.int32(0)))(jdata,
                                              JR.make_pixel_offsets(jcfg))
        cfg = RenderConfig(width=W, height=H, max_bounces=BOUNCES, **kw)
        tcfg = RenderConfig(width=W, height=H, telemetry=True,
                            export_rays=STRIDE, max_bounces=BOUNCES, **kw)
        offsets = R.make_pixel_offsets(cfg)
        timg, tst = R.render_sample(tdata, tspec, tcfg, offsets, 0)
        plain, _ = R.render_sample(tdata, tspec, cfg, offsets, 0)
        out[label] = ({k: np.asarray(v) for k, v in jst.items()}, timg, tst,
                      plain)
    return out


def _counters(stats) -> dict:
    return {k: int(v) for k, v in stats.items()
            if k.rstrip("0123456789") in COUNTERS}


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_telemetry_counters_equal_reference(renders, label):
    jst, _, tst, _ = renders[label]
    got, ref = _counters(tst), _counters(jst)
    assert got == ref
    assert ("rank_unresolved_b1" in got) == (label == "compaction_true")
    for b in range(BOUNCES):
        assert 0 < got[f"shadow_occn_b{b}"] < got[f"shadow_b{b}"]


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_export_rows_match_reference(renders, label):
    jst, _, tst, _ = renders[label]
    keys = sorted(k for k in jst if k.startswith(("rays_b", "srays_b")))
    assert keys == sorted(k for k in tst if k.startswith(("rays_b",
                                                          "srays_b")))
    assert f"rays_b{BOUNCES - 1}" in keys and "srays_b0" in keys
    for k in keys:
        got, ref = tst[k].numpy(), jst[k]
        assert got.shape == ref.shape and got.shape[1] == 8, k
        live = got[:, 7] > 0
        assert set(np.unique(got[:, 7])) <= {0.0, 1.0}
        np.testing.assert_allclose(np.linalg.norm(got[live, 3:6], axis=1),
                                   1.0, atol=1e-5)
        if k.startswith("rays_b"):
            assert np.isinf(got[:, 6]).all()
        else:
            assert np.isfinite(got[live, 6]).all() and (got[live, 6] > 0).all()
        if label == "compaction_false":
            np.testing.assert_array_equal(got[:, 7], ref[:, 7], err_msg=k)
            fin = np.isfinite(ref[:, 6])
            np.testing.assert_array_equal(fin, np.isfinite(got[:, 6]))
            np.testing.assert_allclose(got[:, :6], ref[:, :6], atol=1e-4,
                                       err_msg=k)
            np.testing.assert_allclose(got[fin, 6], ref[fin, 6], atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_telemetry_and_export_leave_the_image(renders, label):
    _, timg, tst, plain = renders[label]
    assert torch.equal(timg, plain)
    for b in range(BOUNCES):  # per ray, over the padded rays of the pass
        for k in (f"visits_b{b}", f"shadow_visits_b{b}"):
            assert tst[k].dtype == torch.int32
            assert tst[k].shape == tst["visits_b0"].shape
    assert tst["visits_b0"].shape[0] >= W * H


def test_visit_percentiles_follow_reference(renders):
    """The port's ``visit_percentiles`` is the JAX function on per-ray
    arrays: same keys and values on the same stats."""
    _, _, tst, _ = renders["compaction_true"]
    host = {k: v.numpy() for k, v in tst.items()}
    got = TM.visit_percentiles(tst, W * H)
    assert got == JM.visit_percentiles(host, W * H)
    assert {"visits_primary_p50_p90", "bounce_visits_mean",
            "shadow_visits_p50_p90_mean", "live_frac_by_bounce",
            "shadow_occluded_frac_by_bounce"} <= set(got)
    assert TM.visit_percentiles({}) == {}
    assert TM.visit_percentiles({"visits_b0": torch.zeros(4, dtype=int),
                                 "visits_b1": torch.zeros(4, dtype=int)}) \
        == JM.visit_percentiles({"visits_b0": np.zeros(4),
                                 "visits_b1": np.zeros(4)})


def test_wavefront_stats_follow_the_counters(dragon, renders):
    _, _, tdata, tspec = dragon
    cfg = RenderConfig(width=W, height=H, max_bounces=BOUNCES)
    got = TM.wavefront_stats(tdata, tspec, cfg, R.make_pixel_offsets(cfg))
    _, _, tst, _ = renders["compaction_false"]
    assert got["closest_per_bounce"] == [int(tst[f"live_b{b}"])
                                         for b in range(BOUNCES)]
    assert got["shadow_per_bounce"] == [int(tst[f"shadow_b{b}"])
                                        for b in range(BOUNCES)]
    assert got["total_rays"] == int(tst["closest_rays"] + tst["shadow_rays"])
    assert set(got) == {"pixels", "closest_per_bounce", "shadow_per_bounce",
                        "occupancy_per_bounce", "total_rays",
                        "rays_per_pixel"}
