"""The plain reference: its binned triangle queries against brute force,
its sampling, its environment map's texels and its ``.hdr`` decoding
against the program's, what it refuses, and a 32x32 cut of each
configuration through the program's plain tracer (``tracer="torch"``)
against the reference, within the cell's limits."""

import numpy as np
import pytest
import torch

from bench_port import harness
from bench_port.reference import (Binned, any_brute, build_scene,
                                  closest_brute, render_pixels)
from bench_port.reference import sampling as RS
from bench_port.scenegen import make_model


def scene(cell_name, w=32, h=32):
    cell = harness.resolve(harness.load_benchmark(), cell_name)
    models = {i["model"]: make_model(i["model"])
              for i in cell["config"]["instances"]}
    return build_scene(cell["config"], models, "cpu", w, h)


@pytest.mark.parametrize("cell", ["dragon-1024.default",
                                  "coatball-1024x768.specular"])
def test_binned_queries_equal_brute_force(cell):
    rs = scene(cell)
    g = torch.Generator().manual_seed(3)
    n = 2000
    o = torch.rand((n, 3), generator=g) * torch.tensor([5.0, 2.0, 5.0]) \
        - torch.tensor([2.5, 0.0, 0.0])
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    d[:7, 0] = 0.0  # axis-parallel rays too
    d = torch.nn.functional.normalize(d, dim=1)
    b = Binned(rs.v0, rs.e1, rs.e2, ray_batch=700, pair_batch=900)
    got = b.closest(o, d)
    want = closest_brute(o, d, rs.v0, rs.e1, rs.e2)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert (got[1] >= 0).sum() > n // 4
    t_max = torch.rand(n, generator=g) * 3.0
    occ = b.any(o, d, t_max)
    assert torch.equal(occ, any_brute(o, d, t_max, rs.v0, rs.e1, rs.e2))
    assert 0 < occ.sum() < n


def test_sampling_matches_the_program_bit_for_bit():
    from metal_raytracing_tpu_torch import sampling as PS

    i = torch.arange(0, 1 << 21, 997, dtype=torch.int32)
    for dim in range(len(RS.PRIMES)):
        assert torch.equal(RS.halton(i, dim), PS.halton(i, dim))
    for seed in (0, 7, 2**31 + 5):
        assert np.array_equal(RS.pixel_offsets(seed, 5000),
                              PS.pixel_decorrelation_offsets(seed, 5000)
                              .numpy())


def test_an_env_map_reads_alike_in_the_program_and_the_reference(tmp_path):
    """The ``.hdr`` bytes scenegen writes, read by the program's reader and
    decoded by the reference, give the same texels, within RGBE's 8 bits
    of the map; and the texel each direction finds is the program's."""
    from metal_raytracing_tpu_torch import renderer as R
    from metal_raytracing_tpu_torch.io.image import read_hdr

    from bench_port.reference.pathtrace import env_texel
    from bench_port.reference.scene import decode_hdr
    from bench_port.scenegen import encode_hdr

    rng = np.random.default_rng(5)
    img = (rng.random((24, 40, 3)) ** 4 * 60.0).astype(np.float32)
    img[0, :3] = 0.0
    data = encode_hdr(img)
    (tmp_path / "m.hdr").write_bytes(data)
    ours = decode_hdr(data)
    assert np.array_equal(ours, read_hdr(str(tmp_path / "m.hdr")))
    peak = img.max(axis=2, keepdims=True)
    assert (np.abs(ours - img) <= peak * 2.0 ** -7).all()
    env = torch.from_numpy(ours)
    d = torch.nn.functional.normalize(
        torch.randn((5000, 3), generator=torch.Generator().manual_seed(1)),
        dim=1)
    d[:4] = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                          [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    assert torch.equal(env_texel(env, d, lambda x: x),
                       R._env_lookup(env, d))


def test_the_reference_refuses_textures_and_dimensions_past_its_primes():
    rs = scene("coatball-1024x768.specular", 4, 3)
    tracer = Binned(rs.v0, rs.e1, rs.e2)
    with pytest.raises(NotImplementedError, match="enable_textures"):
        render_pixels(rs, tracer, {"enable_textures": True}, [0], 1)
    # 12 bounces with refraction draw dimension 97 of 0-99; 13 draw 105
    ok = render_pixels(rs, tracer, {"enable_refraction": True,
                                    "env_map": True, "max_bounces": 12},
                       [0, 5], 1)
    assert np.isfinite(ok).all()
    with pytest.raises(ValueError, match="Halton dimension 105"):
        render_pixels(rs, tracer, {"enable_refraction": True,
                                   "max_bounces": 13}, [0], 1)


@pytest.mark.parametrize("cell,w,h", [("dragon-1024.default", 32, 32),
                                      ("coatball-1024x768.specular", 32, 24)])
def test_a_32x32_cut_agrees_within_the_cell_limits(cell, w, h):
    """The program's plain tracer over every pixel of a small cut and a
    few samples, held against the reference by the cell's own check."""
    import time

    res = harness.run_cell(cell, 2024, 0.5, False, time.perf_counter(),
                           device="cpu",
                           overrides={"width": w, "height": h,
                                      "pixels": w * h,
                                      "render_config": {"tracer": "torch"}})
    assert res["correct"], res["check"]
