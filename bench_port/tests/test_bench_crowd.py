"""``dragon-crowd-1024`` cut to a CPU test: its grid of instances with the
dragon generator's place taken by the sphere's, built with the default
``sah_free`` builder at 16 triangles a cluster, so that it lies past both
of the port's size limits at 88,868 triangles (more than 32 clusters a
super, the wide K3/K4; more than 4,095 padded clusters, the ``dir_major``
sort keys).  The program's CPU path, with ``telemetry`` so that its plain
versions walk supers and clusters as K3/K4 do, renders every pixel of a
32x32 image for 2 samples, held against the reference's ``render_pixels``
on the same pixels and samples."""

import numpy as np
import pytest

from bench_port import check as CK
from bench_port import harness
from bench_port.reference import Binned, build_scene, render_pixels
from bench_port.scenegen import make_model

CELL = "dragon-crowd-1024.default"
W = H = 32
SAMPLES = 2
SEED = 2024


def small_crowd(config):
    """Each dragon a sphere of radius 0.2 standing 0.01 above the floor."""
    def cut(inst):
        if inst["model"] != "dragon":
            return inst
        x, _, z = inst["position"]
        return dict(inst, model="sphere", position=[x, 0.21, z], scale=0.2)

    return dict(config, instances=[cut(i) for i in config["instances"]])


@pytest.fixture(scope="module")
def crowd():
    from metal_raytracing_tpu_torch.types import RenderConfig

    cell = harness.resolve(harness.load_benchmark(), CELL)
    config = small_crowd(cell["config"])
    models = {n: make_model(n) for n in {i["model"] for i in
                                         config["instances"]}}
    scene = harness._port_scene(config, models, W, H, {})
    cfg = RenderConfig(width=W, height=H, seed=SEED, tracer="torch",
                       telemetry=True, cluster_size=16)
    rs = build_scene(config, models, "cpu", W, H)
    reference = render_pixels(rs, Binned(rs.v0, rs.e1, rs.e2),
                              {"seed": SEED}, np.arange(W * H), SAMPLES)
    return scene, cfg, rs, reference, cell["check"]["limits"], render(
        scene, cfg)


def render(scene, cfg, drop_super=None):
    """The program's image after ``SAMPLES`` samples, with the clusters of
    super ``drop_super`` given boxes no ray enters, as a K3 that skipped
    them would walk."""
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.renderer import Renderer

    r = Renderer(scene, cfg, device="cpu")
    if drop_super is not None:
        r.data.clu_planes[drop_super, :, :3] = TC.BIG_T
        r.data.clu_planes[drop_super, :, 3:] = -TC.BIG_T
    r.step(SAMPLES)
    return r, r.accum.reshape(-1, 3).double().numpy()


def busiest_super(r, rs):
    """The super whose triangles most pixel-centre primary rays hit."""
    import torch

    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    i = torch.arange(W * H)
    d = torch.nn.functional.normalize(
        ((i % W + 0.5) / W * 2 - 1)[:, None] * rs.cam_right
        + ((i // W + 0.5) / H * 2 - 1)[:, None] * rs.cam_up
        + rs.cam_forward, dim=1)
    o = rs.cam_pos.expand(W * H, 3).contiguous()
    bvh = r.spec.bvh
    hit = TC.trace_closest(o, d, torch.ones(W * H, dtype=torch.bool),
                           r.data.sup_planes, r.data.clu_planes,
                           r.data.tri_planes, bvh)
    slot = hit.tri[(hit.tri >= 0) & (hit.tri < bvh.global_base)]
    per_super = bvh.cluster_size * r.data.clu_planes.shape[1]
    return int(torch.bincount(slot // per_super).argmax())


def test_the_small_crowd_lies_past_both_limits_and_agrees(crowd):
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC
    from metal_raytracing_tpu_torch.renderer import _MAX_KEY_CLUSTERS

    scene, cfg, rs, reference, limits, (r, program) = crowd
    assert scene.triangle_count < 100_000
    ns, s_per = r.data.clu_planes.shape[:2]
    assert s_per > TC.SHARED_PER_SUPER
    assert ns * s_per > _MAX_KEY_CLUSTERS == 4095
    # The cell's own limits, which decide ``correct`` on the card: the
    # plain walk and the reference differ here only by float32 rounding
    # (gap_mean 1.0e-6 when written).
    numbers = CK.gap_numbers(program, reference)
    assert CK.judge(numbers, limits), numbers


def test_a_walk_that_drops_one_super_is_caught(crowd):
    """The same limits fail a walk that skips every cluster of the super
    most primary rays hit (gap_mean 0.086 when written)."""
    scene, cfg, rs, reference, limits, (r, _) = crowd
    _, broken = render(scene, cfg, drop_super=busiest_super(r, rs))
    numbers = CK.gap_numbers(broken, reference)
    assert not CK.judge(numbers, limits), numbers
