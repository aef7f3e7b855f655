"""Wavefront path-tracing pipeline + progressive renderer, in PyTorch.

The port's counterpart of ``metal_raytracing_tpu.renderer``
(reference: MetalRaytracing/Raytracing.metal:156-405, Renderer.swift:284-351).
For each bounce, every ray is traced (closest hit), shaded from one shade-row
gather with branchless masked math, given one light sample and a shadow ray
(any hit), and re-emitted along a cosine-weighted bounce direction.  Samples
fold into a progressive average.

The port runs the reference's ``compaction=False`` wavefront: rays keep
their pixel (tile) order through every bounce.  The reference's compaction
sorts are a pure permutation of the rays and leave the image unchanged;
porting them is ROADMAP.md's next item.  The shading extensions (specular,
emission, environment map, textures, refraction) are not ported yet.

Both tracers of the port, the CUDA kernels and their plain PyTorch
versions, return the packed key's chopped hit distance, so the renderer
recomputes the exact t from the winner's plane in the shade row, as the
reference does after its Pallas tracer.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import sampling
from .lights import sample_lights, select_light
from .ops import trace_cuda
from .ops.broadphase_cuda import broadphase_keys, broadphase_ref
from .ops.intersect import Hit
from .scene import Scene, SceneData, SceneSpec
from .types import RenderConfig

__all__ = ["render_sample", "render_rays", "pixel_coords", "accumulate",
           "Renderer", "make_pixel_offsets", "make_tracers", "resolve_tracer"]


def make_pixel_offsets(cfg: RenderConfig, device="cpu") -> torch.Tensor:
    """Per-pixel Halton index offsets, (H*W,) int32 in [0, 2^bits)."""
    return sampling.pixel_decorrelation_offsets(
        cfg.seed, cfg.height * cfg.width, bits=cfg.rand_offset_bits,
        device=device)


def _normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp(sampling.norm(v), min=eps)


def resolve_tracer(cfg: RenderConfig, device) -> str:
    """``"cuda"`` or ``"torch"``: ``"auto"`` follows the device, and the
    kernels need a CUDA device."""
    device = torch.device(device)
    if cfg.tracer == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if cfg.tracer == "cuda" and device.type != "cuda":
        raise ValueError(
            f"tracer='cuda' runs the CUDA kernels and needs a CUDA device, "
            f"got {device}; use tracer='torch' for their plain versions")
    return cfg.tracer


def make_tracers(data: SceneData, spec: SceneSpec, tracer: str):
    """(closest(o, d, mask, seed) -> Hit, any_hit(o, d, max_t, mask) ->
    bool) over the scene's packed planes: the kernel wrappers for
    ``tracer="cuda"``, their plain versions for ``"torch"``."""
    if tracer == "cuda":
        def closest(o, d, m, seed):
            return trace_cuda.trace_closest(o, d, m, data.sup_planes,
                                            data.clu_planes, data.tri_planes,
                                            spec.bvh, seed)

        def any_hit(o, d, mt, m):
            return trace_cuda.trace_any(o, d, mt, m, data.sup_planes,
                                        data.clu_planes, data.tri_planes,
                                        spec.bvh)
    else:
        def closest(o, d, m, seed):
            t, tri = trace_cuda.closest_flat_ref(o, d, m, data.tri_planes,
                                                 spec.bvh, seed)
            z = torch.zeros_like(t)
            return Hit(t=t, u=z, v=z, tri=tri)

        def any_hit(o, d, mt, m):
            return trace_cuda.any_flat_ref(o, d, mt, m, data.tri_planes,
                                           spec.bvh)
    return closest, any_hit


def _fused_global(tracer: str, cfg: RenderConfig, data: SceneData, bvh,
                  o, d, mask, max_t=None) -> torch.Tensor:
    """The global set's closest seed key, or with ``max_t`` its 0/1
    occlusion, from the fused broad phase (``cfg.fused_broadphase``): the
    kernel for ``tracer="cuda"``, its plain version otherwise."""
    kw = dict(max_t=max_t, with_clusters=False, any_mode=max_t is not None)
    if tracer == "cuda":
        return broadphase_keys(o, d, mask, data.clu_planes, data.tri_planes,
                               bvh, block=cfg.broadphase_block, **kw)[2]
    return broadphase_ref(o, d, mask, data.clu_planes, data.tri_planes, bvh,
                          **kw)[2]


def pixel_coords(cfg: RenderConfig, device="cpu"):
    """Flat (H*W,) pixel x/y coordinates in row-major order."""
    xs = torch.arange(cfg.width, dtype=torch.float32, device=device)
    ys = torch.arange(cfg.height, dtype=torch.float32, device=device)
    return xs.repeat(cfg.height), ys.repeat_interleave(cfg.width)


# Tile shapes per ray-block size: each block of rays covers a compact image
# tile (reference: Renderer.swift:295-300; Raytracing.metal:156).
_TILE_SHAPES = {64: (8, 8), 128: (8, 16), 256: (16, 16), 512: (16, 32),
                1024: (32, 32)}


def tile_shape(cfg: RenderConfig) -> Optional[Tuple[int, int]]:
    """(tile_h, tile_w) of the primary ray block when the image divides
    evenly, else None."""
    th_tw = _TILE_SHAPES.get(cfg.primary_ray_block or cfg.ray_block)
    if th_tw is None:
        return None
    th, tw = th_tw
    if cfg.height % th or cfg.width % tw:
        return None
    return th, tw


def _tile_flatten(img2d: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(H, W, ...) -> flat (H*W, ...) in tile-major order."""
    h, w = img2d.shape[0], img2d.shape[1]
    rest = tuple(img2d.shape[2:])
    t = img2d.reshape((h // th, th, w // tw, tw) + rest)
    return t.movedim(2, 1).reshape((h * w,) + rest)


def _tile_unflatten(flat: torch.Tensor, h: int, w: int, th: int,
                    tw: int) -> torch.Tensor:
    """Inverse of :func:`_tile_flatten`."""
    rest = tuple(flat.shape[1:])
    t = flat.reshape((h // th, w // tw, th, tw) + rest)
    return t.movedim(1, 2).reshape((h, w) + rest)


def render_rays(data: SceneData, spec: SceneSpec, cfg: RenderConfig,
                px: torch.Tensor, py: torch.Tensor, offsets: torch.Tensor,
                frame_index: int, tracer: str = "torch", tracers=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Path-trace one sample for a flat set of pixels.

    ``tracers`` overrides the (closest, any_hit) pair of
    :func:`make_tracers` (a caller may wrap it to record each pass's rays).
    Returns ((N, 3) radiance, stats); ``stats`` counts the traced rays for
    the Mrays/s metric: ``closest_rays`` and ``shadow_rays`` (0-d int64
    tensors, left on the device)."""
    w, h = cfg.width, cfg.height
    n = px.shape[0]
    dev = px.device
    block = cfg.ray_block
    pblock = cfg.primary_ray_block or block
    sblock = cfg.shadow_ray_block or block
    # rays padded to a common multiple of all block sizes, as the reference
    pad_to = math.lcm(block, pblock, sblock)
    if cfg.fused_broadphase:
        pad_to = math.lcm(pad_to, cfg.broadphase_block)
    p = -(-n // pad_to) * pad_to
    pad = p - n
    lcount = spec.light_count
    bvh = spec.bvh
    fold_global = cfg.host_seed and bvh.num_global > 0

    px = torch.nn.functional.pad(px, (0, pad))
    py = torch.nn.functional.pad(py, (0, pad))
    alive = torch.arange(p, device=dev) < n
    idx = torch.nn.functional.pad(offsets.to(torch.int32), (0, pad)) \
        + frame_index

    # Camera ray generation (reference: Raytracing.metal:201-218).
    jitter_x = sampling.halton(idx, sampling.DIM_PIXEL_X)
    jitter_y = sampling.halton(idx, sampling.DIM_PIXEL_Y)
    uv_x = (px + jitter_x) / w * 2.0 - 1.0
    uv_y = (py + jitter_y) / h * 2.0 - 1.0
    cam = data.camera
    d = _normalize(uv_x[:, None] * cam.right[None]
                   + uv_y[:, None] * cam.up[None] + cam.forward[None])
    o = cam.position[None].expand(p, 3)

    closest_fn, any_fn = tracers or make_tracers(data, spec, tracer)
    color = torch.ones((p, 3), device=dev)  # path throughput (:226)
    accum = torch.zeros((p, 3), device=dev)
    closest_count = torch.zeros((), dtype=torch.int64, device=dev)
    shadow_count = torch.zeros((), dtype=torch.int64, device=dev)

    for bounce in range(cfg.max_bounces):
        closest_count += alive.sum()
        # The closest pass is always seeded on the host side: the port's
        # kernels have no in-kernel global-set test.
        seed = None
        if bvh.num_global and cfg.fused_broadphase:
            seed = _fused_global(tracer, cfg, data, bvh, o, d, alive)
        elif bvh.num_global:
            seed = trace_cuda.global_seed_keys(o, d, alive, data.tri_planes,
                                               bvh)
        hit = closest_fn(o, d, alive, seed)
        alive = alive & hit.found  # the megakernel's break on miss (:246-247)
        row = data.shade_table[hit.tri.clamp(min=0).long()]

        # Exact hit distance from the winner's plane [n, n.v0] in the shade
        # row: t = (n.v0 - n.o) / (n.d); the tracer's t is chopped.
        nrow = row[:, 16:19]
        den = (nrow * d).sum(-1)
        num = row[:, 19] - (nrow * o).sum(-1)
        tiny = torch.where(den < 0, -1e-20, 1e-20).to(den.dtype)
        t_hit = num / torch.where(den.abs() < 1e-20, tiny, den)
        # Dead lanes keep pos = o (no BIG_T overflow into the light math).
        pos = o + d * torch.where(alive, t_hit, 0.0)[:, None]
        # ns = M pos + m0: barycentric corner-normal interpolation
        # (reference: Raytracing.metal:60-73).
        ns = (row[:, 0:3] * pos[:, 0:1] + row[:, 3:6] * pos[:, 1:2]
              + row[:, 6:9] * pos[:, 2:3] + row[:, 9:12])
        ns = _normalize(ns)
        base_color = row[:, 12:15]

        # One uniformly random light per ray (reference: :272-275).
        lu = sampling.halton(idx, sampling.bounce_dim(bounce, 0))
        light_idx = select_light(lu, lcount)
        r_light = torch.stack(
            [sampling.halton(idx, sampling.bounce_dim(bounce, 1)),
             sampling.halton(idx, sampling.bounce_dim(bounce, 2))], dim=-1)
        ls = sample_lights(data.lights, light_idx, r_light, pos)

        ndotl = torch.clamp((ns * ls.direction).sum(-1), 0.0, 1.0)
        lcolor = ls.color * ndotl[:, None] * lcount  # :331-335
        # Diffuse throughput for this vertex's light sample (:339).
        dcolor = torch.where(alive[:, None], color * base_color, color)
        do_shadow = alive & (sampling.norm(lcolor)[:, 0] > 1e-4)  # :341
        shadow_count += do_shadow.sum()
        shadow_o = pos + ns * 1e-3  # :350
        sdist = ls.distance - 1e-3
        # Global-set occlusion on the host side of the kernel: rays the
        # scene-spanning planes occlude leave the kernel's mask (they still
        # count as traced shadow rays).
        if fold_global and cfg.fused_broadphase:
            g_occ = _fused_global(tracer, cfg, data, bvh, shadow_o,
                                  ls.direction, do_shadow, sdist) > 0
        elif fold_global:
            g_occ = trace_cuda.global_any_hit(shadow_o, ls.direction, sdist,
                                              do_shadow, data.tri_planes, bvh)
        else:
            g_occ = torch.zeros_like(do_shadow)
        occluded = any_fn(shadow_o, ls.direction, sdist, do_shadow & ~g_occ)
        visible = do_shadow & ~occluded & ~g_occ
        accum = accum + torch.where(visible[:, None], lcolor * dcolor,
                                    torch.zeros_like(accum))  # :371-373

        # Cosine-weighted diffuse bounce (reference: :384-391).
        r_bounce = torch.stack(
            [sampling.halton(idx, sampling.bounce_dim(bounce, 3)),
             sampling.halton(idx, sampling.bounce_dim(bounce, 4))], dim=-1)
        local = sampling.sample_cosine_weighted_hemisphere(r_bounce)
        d = sampling.align_hemisphere_with_normal(local, ns)
        o = shadow_o
        color = dcolor

    stats = {"closest_rays": closest_count, "shadow_rays": shadow_count}
    return accum[:n], stats


def render_sample(data: SceneData, spec: SceneSpec, cfg: RenderConfig,
                  offsets: torch.Tensor, frame_index: int,
                  tracer: str = "torch", tracers=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render one full-frame sample; returns ((H, W, 3) radiance, stats).

    Pixels are traced in tile-major order when the image divides into
    primary-block tiles, then restored to row-major order."""
    px, py = pixel_coords(cfg, offsets.device)
    tiles = tile_shape(cfg)
    if tiles is not None:
        th, tw = tiles
        px = _tile_flatten(px.reshape(cfg.height, cfg.width), th, tw)
        py = _tile_flatten(py.reshape(cfg.height, cfg.width), th, tw)
        offsets = _tile_flatten(offsets.reshape(cfg.height, cfg.width),
                                th, tw)
    radiance, stats = render_rays(data, spec, cfg, px, py, offsets,
                                  frame_index, tracer, tracers)
    if tiles is not None:
        return _tile_unflatten(radiance, cfg.height, cfg.width, th, tw), stats
    return radiance.reshape(cfg.height, cfg.width, 3), stats


def accumulate(prev: torch.Tensor, sample: torch.Tensor,
               frame_index: int) -> torch.Tensor:
    """Progressive average (reference: Raytracing.metal:395-401)."""
    fi = float(np.float32(frame_index))
    return (prev * fi + sample) / (fi + 1.0)


class Renderer:
    """Progressive renderer: owns the scene tensors on ``device`` and the
    accumulation state (reference: Renderer.swift:12-357, headless).

    The (accumulation image, sample count, seed) triple is the checkpoint
    state; checkpoints use the JAX package's npz keys and fingerprint, so
    they load across the two packages."""

    def __init__(self, scene: Scene, cfg: RenderConfig, device="cuda"):
        self.scene = scene
        self.cfg = cfg
        self.device = torch.device(device)
        self.tracer = resolve_tracer(cfg, self.device)
        self.data, self.spec = scene.build(
            cluster_size=cfg.cluster_size, builder=cfg.bvh_builder,
            device=self.device)
        self.offsets = make_pixel_offsets(cfg, self.device)
        self.reset()

    def reset(self) -> None:
        """Restart progressive accumulation (reference:
        Renderer.swift:353-355)."""
        self.frame_index = 0
        self.accum = torch.zeros((self.cfg.height, self.cfg.width, 3),
                                 dtype=torch.float32, device=self.device)
        self.ray_totals = torch.zeros((2,), dtype=torch.float32,
                                      device=self.device)

    def step(self, k: int = 1) -> None:
        """Render ``k`` samples for every pixel and fold them into the
        average.  Nothing here waits for the device."""
        for _ in range(k):
            sample, stats = render_sample(self.data, self.spec, self.cfg,
                                          self.offsets, self.frame_index,
                                          self.tracer)
            self.accum = accumulate(self.accum, sample, self.frame_index)
            self.ray_totals = self.ray_totals + torch.stack(
                [stats["closest_rays"], stats["shadow_rays"]]).float()
            self.frame_index += 1

    @property
    def total_closest_rays(self) -> int:
        """Total closest-hit rays traced (waits for the device)."""
        return int(self.ray_totals[0])

    @property
    def total_shadow_rays(self) -> int:
        """Total shadow rays traced (waits for the device)."""
        return int(self.ray_totals[1])

    def render(self, spp: Optional[int] = None) -> np.ndarray:
        """Render ``spp`` more samples (default cfg.spp); returns the
        (H, W, 3) float32 average."""
        self.step(self.cfg.spp if spp is None else spp)
        return self.image

    @property
    def image(self) -> np.ndarray:
        return self.accum.cpu().numpy()

    # -- checkpoint / resume -------------------------------------------------
    def fingerprint(self) -> str:
        """Scene + config identity baked into checkpoints (the JAX
        package's string, so checkpoints load across the two packages).
        The tracer is not part of it: the tracers give the same image."""
        s = (f"{self.spec.bvh}|L{self.spec.light_count}"
             f"|M{self.spec.material_count}|E{int(self.spec.has_env_map)}"
             f"|{self.cfg.width}x{self.cfg.height}|b{self.cfg.max_bounces}"
             f"|seed{self.cfg.seed}")
        return hashlib.sha1(s.encode()).hexdigest()[:16]

    @property
    def total_samples(self) -> int:
        """Samples folded into ``accum`` so far."""
        return self.frame_index

    def state_dict(self) -> dict:
        return {
            "accum": self.image,
            "total_samples": self.total_samples,
            "seed": self.cfg.seed,
            "fingerprint": self.fingerprint(),
            "total_closest_rays": self.total_closest_rays,
            "total_shadow_rays": self.total_shadow_rays,
        }

    def load_state(self, state: dict) -> None:
        if int(state["seed"]) != self.cfg.seed:
            raise ValueError("checkpoint seed does not match config seed")
        if "fingerprint" in state:
            fp = state["fingerprint"]
            got = str(np.asarray(fp).item() if hasattr(fp, "item") else fp)
            if got != self.fingerprint():
                raise ValueError(
                    "checkpoint scene/config fingerprint does not match: "
                    f"checkpoint {got}, this renderer {self.fingerprint()}")
        total = int(state["total_samples"] if "total_samples" in state
                    else state["frame_index"])
        self.accum = torch.as_tensor(np.asarray(state["accum"], np.float32),
                                     device=self.device)
        self.frame_index = total
        self.ray_totals = torch.tensor(
            [float(state.get("total_closest_rays", 0)),
             float(state.get("total_shadow_rays", 0))],
            dtype=torch.float32, device=self.device)

    @staticmethod
    def checkpoint_path(path: str) -> str:
        """``np.savez`` appends ``.npz`` when absent; both save and load
        normalize so ``--checkpoint ckpt`` round-trips."""
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        np.savez(self.checkpoint_path(path), **self.state_dict())

    def load(self, path: str) -> None:
        with np.load(self.checkpoint_path(path)) as f:
            self.load_state({k: f[k] for k in f.files})
