"""``nearest_cluster_kernel`` on the renderer's main path on the card: the
launches of one dragon sample of each compaction config, and dragon images
at ``compaction=True`` (and ``rank_trace=2``) through the kernel equal to
those through the plain chain.  On the CPU every case skips.
The file imports no JAX, so it runs on the card:
``python -m pytest --noconftest tests/test_torch_exact_broadphase_*.py``."""

import pytest
import torch

from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.scenes import get_scene
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import card

CONFIGS = {  # config -> (single-direction launches, pair launches) a sample
    "B": (dict(compaction=True), (2, 1)),
    "rank_trace=2": (dict(compaction=True, rank_trace=2), (2, 1)),
    "D": (dict(compaction=True, fused_broadphase=True), (1, 0)),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_launches_of_one_sample(config):
    """One eager dragon sample: config B and ``rank_trace=2`` launch the
    kernel twice in one direction (bounce 1's ranks, the last bounce's
    super-level shadow fold) and once as the pair; config D (K5's keys)
    once, the super-level fold."""
    dev = card()
    kw, (single, pair) = CONFIGS[config]
    r = R.Renderer(get_scene("dragon", 256, 256),
                   RenderConfig(width=256, height=256, **kw), device=dev)
    TC.reset_launch_counts()
    R.render_sample(r.data, r.spec, r.cfg, r.offsets, 0, r.tracer,
                    baked_tables=r.baked)
    torch.cuda.synchronize()
    assert (BP.nearest_cluster.launches,
            BP.nearest_cluster.launches_pair) == (single, pair)


@pytest.mark.parametrize("config", ["B", "rank_trace=2"])
def test_compaction_image_equals_plain_chain(config, monkeypatch):
    """Dragon 512x512 through the graphed main path: the image with the
    kernel's keys equals the image with the plain chain's, bit for bit."""
    dev = card()
    kw = CONFIGS[config][0]
    images = []
    for plain in (False, True):
        with monkeypatch.context() as mp:
            if plain:
                mp.setattr(BP, "_device_path", lambda o: False)
            r = R.Renderer(get_scene("dragon", 512, 512),
                           RenderConfig(width=512, height=512, **kw),
                           device=dev)
            r.render(4)
            torch.cuda.synchronize()
            images.append(r.accum.clone())
    assert torch.equal(images[0], images[1])
