"""Feedback-driven re-clustering in the port against the JAX package, on
the CPU: ``RenderConfig.export_rays``, the ``sah_rays`` rebuild,
``Renderer.refine`` and the CLI's ``--bvh-builder`` / ``--feedback``.

Clustering moves work, not the image: a rebuild to the measured rays keeps
the image within RMSE 1e-5, the gate of the JAX package's own test
(``tests/test_feedback.py``), and the fingerprint is pinned before the
rebuild, so checkpoints written after ``refine`` load in the JAX renderer
and the other way round.
"""

import dataclasses

import numpy as np
import pytest
import torch

from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.io.image import rmse
from metal_raytracing_tpu.renderer import Renderer as JRenderer
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.cli import main as cli_main
from metal_raytracing_tpu_torch.io import procedural as tproc
from metal_raytracing_tpu_torch.scenes import library as tlib
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import few_torch_threads  # noqa: F401

SIZE = 32
BOUNCES = 2  # each bounce is one more JAX compile
REFINE_RMSE = 1e-5  # tests/test_feedback.py's gate


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


def renderer(scene="plane_sphere", **kw):
    kw.setdefault("max_bounces", BOUNCES)
    return R.Renderer(tlib.get_scene(scene, SIZE, SIZE),
                      RenderConfig(width=SIZE, height=SIZE, **kw),
                      device="cpu")


def test_export_rays_rebuild_keeps_the_image():
    """As the JAX test: an exported sample's (M, 8) rows rebuild the
    clusters with ``sah_rays``, and the rebuilt scene renders the same
    image."""
    r = renderer(max_bounces=2)
    cfg = dataclasses.replace(r.cfg, export_rays=4)
    img1, stats = R.render_sample(r.data, r.spec, cfg, r.offsets, 0)
    keys = sorted(k for k in stats if k.startswith(("rays_b", "srays_b")))
    assert keys == ["rays_b0", "rays_b1", "srays_b0", "srays_b1"]
    rows = [stats[k].numpy() for k in keys]
    for row in rows:
        assert row.shape == (SIZE * SIZE // 4, 8)
    assert np.isinf(stats["rays_b1"][:, 6].numpy()).all()
    s0 = stats["srays_b0"].numpy()
    assert np.isfinite(s0[s0[:, 7] > 0, 6]).all()
    rays = np.concatenate(rows)
    assert (rays[:, 7] > 0).sum() > 0
    img0, _ = R.render_sample(r.data, r.spec, r.cfg, r.offsets, 0)
    assert torch.equal(img1, img0)  # the export leaves the image
    data2, spec2 = r.scene.build(cluster_size=r.cfg.cluster_size,
                                 builder="sah_rays", rays=rays, device="cpu")
    assert not torch.equal(data2.tri_src, r.data.tri_src)
    img2, _ = R.render_sample(data2, spec2, r.cfg, r.offsets, 0)
    assert rmse(img2.numpy(), img0.numpy()) < REFINE_RMSE


@pytest.mark.parametrize("scene", ["plane_sphere", "coatball"])
def test_refine_keeps_the_image(scene):
    """One sample, ``refine``, one more: the unrefined two-sample image.
    (At 32x32 the default stride leaves a subtree fewer rays than
    ``sah_rays`` scores by, so the sample is denser here.)"""
    ref = renderer(scene).render(2)
    r = renderer(scene)
    fp = r.fingerprint()
    r.render(1)
    before = r.data.tri_src
    assert r.refine(stride=4)
    assert not torch.equal(r.data.tri_src, before)  # other clusters
    assert r.fingerprint() == fp
    img = r.render(1)
    assert r.total_samples == 2
    assert rmse(img, ref) < REFINE_RMSE


def test_refined_checkpoints_load_across_packages(tmp_path):
    """A port checkpoint written after ``refine`` resumes in the JAX
    renderer, and a JAX checkpoint written after its ``refine`` in the
    port; each continues the other's image."""
    jr = JRenderer(jlib.get_scene("plane_sphere", SIZE, SIZE),
                   JConfig(width=SIZE, height=SIZE, max_bounces=BOUNCES))
    tr = renderer()
    tr.render(1)
    assert tr.refine()
    path = str(tmp_path / "port.npz")
    tr.save(path)
    jr.load(path)
    assert jr.total_samples == 1
    np.testing.assert_array_equal(jr.image, tr.image)
    jr.render(1)
    tr.render(1)
    assert rmse(jr.image, tr.image) < 1e-3
    assert jr.refine()
    path = str(tmp_path / "jax.npz")
    jr.save(path)
    back = renderer()
    back.load(path)
    assert back.total_samples == 2
    np.testing.assert_array_equal(back.image, jr.image)


def test_cli_bvh_builder_and_feedback(tmp_path, capsys):
    out = str(tmp_path / "fb.png")
    assert cli_main(["render", "--device", "cpu", "--scene", "coatball",
                     "--size", f"{SIZE}x{SIZE}", "--spp", "2",
                     "--bounces", str(BOUNCES),
                     "--bvh-builder", "sah_chunk", "--feedback", "1",
                     "--out", out]) == 0
    err = capsys.readouterr().err
    assert "118 clusters" in err  # coatball's sah_chunk build
    assert "feedback rebuild at sample 1" in err
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(SystemExit):
        cli_main(["render", "--bvh-builder", "octree"])
