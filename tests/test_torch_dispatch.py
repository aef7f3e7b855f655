"""``samples_per_dispatch`` in the port against the JAX package, on the CPU.

The JAX package renders k samples a jitted dispatch; the port's
``Renderer.step(k)`` renders them as one CUDA graph replay on a card, and
eagerly on the CPU, where these tests run (``renderer.graphs_apply``).  What
the CPU can check: the auto tiers and ``dispatch_span`` equal the JAX
package's, the device frame counter gives the int form's bits, batched
renders and checkpoints equal step-by-step ones, and a batched render stays
within the golden gate of the JAX package's batched render.  The graphs
themselves are checked on the card (``chip_smoke.py`` phase 20).
"""

import itertools

import numpy as np
import pytest
import torch

from metal_raytracing_tpu.cli import dispatch_span as jax_dispatch_span
from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.renderer import Renderer as JRenderer
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.cli import dispatch_span
from metal_raytracing_tpu_torch.io import procedural as tproc
from metal_raytracing_tpu_torch.scenes import library as tlib
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import assert_image_gate, few_torch_threads  # noqa: F401

SIZE = 16
BOUNCES = 2


@pytest.fixture(scope="module", autouse=True)
def procedural_models():
    """Both packages build their scenes from the procedural stand-ins."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jlib, "resolve_model", lambda n, prefer_file=True:
               jproc.make_model(n))
    mp.setattr(tlib, "resolve_model", lambda n, prefer_file=True:
               tproc.make_model(n))
    yield
    mp.undo()


def config(size=SIZE, **kw) -> RenderConfig:
    return RenderConfig(width=size, height=size, max_bounces=BOUNCES, **kw)


def renderer(**kw) -> R.Renderer:
    return R.Renderer(tlib.get_scene("plane_sphere", SIZE, SIZE), config(**kw),
                      device="cpu")


@pytest.mark.parametrize("side,spd", [(128, 0), (256, 0), (512, 0),
                                      (1024, 0), (64, 3)])
def test_auto_tiers_match_jax(side, spd):
    jr = JRenderer(jlib.get_scene("plane_sphere", side, side),
                   JConfig(width=side, height=side, samples_per_dispatch=spd))
    tr = R.Renderer(tlib.get_scene("plane_sphere", side, side),
                    RenderConfig(width=side, height=side,
                                 samples_per_dispatch=spd), device="cpu")
    assert tr.samples_per_dispatch == jr.samples_per_dispatch
    assert tr.samples_per_dispatch == (spd or {128: 8, 256: 8, 512: 4,
                                               1024: 2}[side])


def test_dispatch_span_matches_jax():
    for frame, batch, spp, save_every in itertools.product(
            range(13), (1, 3, 4, 7), (1, 5, 6, 8, 13), (None, 0, 1, 2, 4, 5)):
        if frame < spp:
            got = dispatch_span(frame, batch, spp, save_every)
            assert got == jax_dispatch_span(frame, batch, spp, save_every), \
                (frame, batch, spp, save_every)
            assert 1 <= got <= spp - frame


def test_frame_tensor_and_eager_predicate():
    r = renderer()
    frame = torch.tensor(5, dtype=torch.int32)
    img_i, stats_i = R.render_sample(r.data, r.spec, r.cfg, r.offsets, 5)
    img_t, stats_t = R.render_sample(r.data, r.spec, r.cfg, r.offsets, frame)
    assert torch.equal(img_i, img_t) and img_i.max() > 0.01
    for k in ("closest_rays", "shadow_rays"):
        assert torch.equal(stats_i[k], stats_t[k])
    prev = torch.rand((SIZE, SIZE, 3), generator=torch.Generator().manual_seed(0))
    assert torch.equal(R.accumulate(prev, img_i, 5),
                       R.accumulate(prev, img_i, frame))
    # eager: the CPU, telemetry, export_rays, the plain tracer versions
    # and the sharded renderer
    assert not r.graphed and not R.graphs_apply(config(), "cpu", "torch")
    for tracer in ("cuda", "bvh", "bruteforce"):
        assert R.graphs_apply(config(), "cuda", tracer), tracer
    assert not R.graphs_apply(config(), "cuda", "torch")
    assert not R.graphs_apply(config(telemetry=True), "cuda", "cuda")
    assert not R.graphs_apply(config(export_rays=64), "cuda", "cuda")
    assert not R.graphs_apply(config(), "cuda", "cuda", sharded=True)


def test_batched_render_and_checkpoint(tmp_path):
    batched = renderer(samples_per_dispatch=4)
    img = batched.render(6)  # a step of 4, then the remainder of 2
    single = renderer(samples_per_dispatch=4)
    for _ in range(6):
        single.step(1)
    assert np.array_equal(img, single.image) and img.max() > 0.01
    assert batched.total_samples == single.total_samples == 6
    assert int(batched.frame) == 6
    assert torch.equal(batched.ray_totals, single.ray_totals)
    assert batched.total_closest_rays > 0
    # a checkpoint written after one batch resumes into the straight render
    first = renderer(samples_per_dispatch=4)
    first.step()
    assert first.total_samples == 4
    path = str(tmp_path / "ckpt")
    first.save(path)
    resumed = renderer(samples_per_dispatch=4)
    resumed.load(path)
    assert int(resumed.frame) == 4
    assert np.array_equal(resumed.render(2), img)
    assert torch.equal(resumed.ray_totals, batched.ray_totals)
    jr = JRenderer(jlib.get_scene("plane_sphere", SIZE, SIZE),
                   JConfig(width=SIZE, height=SIZE, max_bounces=BOUNCES))
    jr.load(path)  # checks the fingerprint
    assert jr.total_samples == 4
    np.testing.assert_array_equal(np.asarray(jr.accum), first.image)


def test_batched_render_against_jax():
    spp = 4
    jr = JRenderer(jlib.get_scene("plane_sphere", SIZE, SIZE),
                   JConfig(width=SIZE, height=SIZE, max_bounces=BOUNCES,
                           samples_per_dispatch=2))
    ref = jr.render(spp)
    assert jr.total_samples == spp
    tr = renderer(samples_per_dispatch=2)
    got = tr.render(spp)
    assert tr.total_samples == spp
    assert_image_gate(got, ref, "plane_sphere, two samples a step")
