"""Headless CLI of the port: progressive render to PNG/HDR with checkpoints.

Usage:
    python -m metal_raytracing_tpu_torch render --scene dragon \
        --size 1024x1024 --spp 8 --out dragon.png
    python -m metal_raytracing_tpu_torch parity --scene coatball
    python -m metal_raytracing_tpu_torch scenes

``--device`` defaults to ``cuda``; there is no silent fallback to the CPU
(pass ``--device cpu`` to render with the kernels' plain PyTorch versions).
``--tracer bvh --compaction`` is the path the JAX package's CLI renders off
a TPU: the exact BVH walk, through its kernels on a CUDA device.
As in the JAX package's CLI, each extension scene turns its shading
extension on: specular for coatball, the environment map for bunny_env (or
any scene with a map), textures for uv_test, refraction for glass_sphere.
``parity`` renders one scene, with those defaults, through the CUDA kernels
and through their plain versions on one CUDA device and reports the RMSE
between the two images; it refuses any other device.  ``--bvh-builder``
picks the leaf clustering (the JAX CLI's choices), and ``--feedback N``
rebuilds the clusters to the measured rays after N samples
(``Renderer.refine``) and goes on: the same image.  ``render`` steps in the
renderer's dispatch batches (``dispatch_span``), each one CUDA graph replay
where the renderer runs graphs, landing on every ``--save-every`` boundary
and on the ``--feedback`` sample.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .io import image as image_io
from .renderer import Renderer
from .scenes import SCENES, get_scene
from .types import TEXTURE_FILTERS, TRACERS, RenderConfig

PARITY_RMSE = 1e-3  # the reference's parity target (BASELINE.md)


def _parse_size(s: str):
    w, _, h = s.partition("x")
    return int(w), int(h or w)


# The JAX CLI's --bvh-builder choices (sah_rays takes a measured sample,
# which --feedback gives).
BUILDER_CHOICES = ("sah", "sah_free", "sah_chunk", "median", "morton", "ploc")

# What ``render_config`` reads of the shading flags where a command has
# none of them: every extension off but the scene's own.
_NO_SHADING_FLAGS = dict(env_map=False, specular=False, emission=False,
                         textures=False, refraction=False,
                         texture_filter="nearest")


def _add_scene_args(p: argparse.ArgumentParser, scene: str, size) -> None:
    """The scene, size, path and device flags that ``render`` and
    ``parity`` share."""
    p.add_argument("--scene", default=scene, choices=sorted(SCENES))
    p.add_argument("--size", type=_parse_size, default=size, metavar="WxH")
    p.add_argument("--bounces", type=int, default=3,
                   help="path depth (reference hardcodes 3)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    p.add_argument("--bvh-builder", default=RenderConfig.bvh_builder,
                   choices=BUILDER_CHOICES,
                   help="leaf clustering strategy (RenderConfig.bvh_builder)")


def _add_shading_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--env-map", action="store_true",
                   help="enable HDR environment lighting on miss")
    p.add_argument("--specular", action="store_true",
                   help="enable specular (Ks/Ns) reflection lobes")
    p.add_argument("--emission", action="store_true",
                   help="enable emissive (Ke) materials")
    p.add_argument("--textures", action="store_true",
                   help="enable UV-mapped base-color textures (map_Kd)")
    p.add_argument("--refraction", action="store_true",
                   help="enable dielectric refraction (Ni/d materials)")
    p.add_argument("--texture-filter", default="nearest",
                   choices=TEXTURE_FILTERS,
                   help="texture sampling filter (with --textures)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="metal_raytracing_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render a scene to an image")
    _add_scene_args(r, "dragon", (512, 512))
    _add_shading_args(r)
    r.add_argument("--spp", type=int, default=4, help="samples per pixel")
    r.add_argument("--tracer", default="auto", choices=TRACERS,
                   help="cuda: the cluster kernels; torch: their plain "
                        "versions; auto: follow the device; bvh: the exact "
                        "BVH walk (its kernels on a CUDA device, their plain "
                        "versions on the CPU); bruteforce: the oracle")
    r.add_argument("--out", default="render.png")
    r.add_argument("--hdr-out", default=None,
                   help="also write linear HDR output")
    r.add_argument("--no-tonemap", action="store_true")
    r.add_argument("--checkpoint", default=None,
                   help="checkpoint path for save/resume")
    r.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    r.add_argument("--save-every", type=int, default=0,
                   help="write the image (and checkpoint) every N samples")
    r.add_argument("--compaction", action="store_true",
                   help="sort the rays between bounces (same image)")
    r.add_argument("--rank-trace", type=int, default=0, choices=(0, 2),
                   help="with --compaction: rank-directed closest walk over "
                        "this many candidate clusters a ray (0 = off)")
    r.add_argument("--feedback", type=int, default=0, metavar="N",
                   help="after N samples, rebuild the clusters to the "
                        "measured rays (Renderer.refine, the sah_rays "
                        "builder) and go on; the same image")
    r.add_argument("--quiet", action="store_true")

    sub.add_parser("scenes", help="list available scenes")

    pa = sub.add_parser(
        "parity",
        help="render through the CUDA kernels and through their plain "
             f"versions on the card; report the RMSE (target < "
             f"{PARITY_RMSE})")
    _add_scene_args(pa, "plane_sphere", (64, 64))
    pa.add_argument("--spp", type=int, default=1)
    pa.set_defaults(**_NO_SHADING_FLAGS)
    return p


def render_config(args, scene, **kw) -> RenderConfig:
    """The config of ``args`` for ``scene``, with the JAX package's CLI's
    per-scene shading defaults."""
    width, height = args.size
    return RenderConfig(
        width=width, height=height, max_bounces=args.bounces, seed=args.seed,
        env_map=args.env_map or scene.env_map is not None,
        enable_specular=args.specular or scene.name == "coatball",
        enable_emission=args.emission,
        enable_textures=args.textures or scene.name == "uv_test",
        texture_filter=args.texture_filter,
        enable_refraction=args.refraction or scene.name == "glass_sphere",
        bvh_builder=args.bvh_builder, **kw)


def dispatch_span(frame_index: int, samples_per_dispatch: int,
                  spp: int, save_every: int | None) -> int:
    """Samples for the next progressive step from ``frame_index``
    (``metal_raytracing_tpu.cli.dispatch_span``).

    The batch (``samples_per_dispatch``) must not overshoot the requested
    ``spp`` (checkpoints count exact samples) and must land on every
    ``--save-every`` boundary, not stride past it (a batch of 4 with
    ``--save-every 2`` would otherwise never save)."""
    k = min(samples_per_dispatch, spp - frame_index)
    if save_every:
        k = min(k, save_every - frame_index % save_every)
    return k


def cmd_render(args) -> int:
    width, height = args.size
    scene = get_scene(args.scene, width, height)
    cfg = render_config(args, scene, spp=args.spp, tracer=args.tracer,
                        compaction=args.compaction,
                        rank_trace=args.rank_trace)
    t0 = time.perf_counter()
    renderer = Renderer(scene, cfg, device=args.device)
    if not args.quiet:
        print(f"scene {scene.name}: {scene.triangle_count} triangles, "
              f"{renderer.spec.bvh.num_clusters} clusters, tracer "
              f"{renderer.tracer} on {renderer.device}, build "
              f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)

    if (args.resume and args.checkpoint
            and os.path.exists(Renderer.checkpoint_path(args.checkpoint))):
        renderer.load(args.checkpoint)
        if not args.quiet:
            print(f"resumed at sample {renderer.frame_index}",
                  file=sys.stderr)

    tonemap = not args.no_tonemap
    # Each progress print reads the ray counters, which waits for the
    # device, so the prints are rate-limited as in the JAX package's CLI.
    progress_every = max(1, args.spp // 16)
    t0 = time.perf_counter()
    rays0 = renderer.total_closest_rays + renderer.total_shadow_rays
    feedback_at = args.feedback if args.feedback > 0 else None
    while renderer.frame_index < args.spp:
        k = dispatch_span(renderer.frame_index,
                          renderer.samples_per_dispatch, args.spp,
                          args.save_every)
        if feedback_at and renderer.frame_index < feedback_at:
            k = min(k, feedback_at - renderer.frame_index)
        renderer.step(k)
        if feedback_at and renderer.frame_index >= feedback_at:
            feedback_at = None
            ok = renderer.refine()
            if not args.quiet:
                print(f"\nfeedback rebuild at sample {renderer.frame_index}"
                      f": " + (f"{renderer.spec.bvh.num_clusters} clusters"
                               if ok else "no sample (skipped)"),
                      file=sys.stderr)
        if args.save_every and renderer.frame_index % args.save_every == 0:
            image_io.write_png(args.out, renderer.image, tonemap=tonemap)
            if args.checkpoint:
                renderer.save(args.checkpoint)
        if not args.quiet and (renderer.frame_index % progress_every == 0
                               or renderer.frame_index == args.spp):
            el = time.perf_counter() - t0
            rays = (renderer.total_closest_rays + renderer.total_shadow_rays
                    - rays0)
            print(f"\rsample {renderer.frame_index}/{args.spp}  {el:.1f}s  "
                  f"{rays / max(el, 1e-9) / 1e6:.1f} Mrays/s", end="",
                  file=sys.stderr)
    if not args.quiet:
        print(file=sys.stderr)

    image_io.write_png(args.out, renderer.image, tonemap=tonemap)
    if args.hdr_out:
        image_io.write_hdr(args.hdr_out, renderer.image)
    if args.checkpoint:
        renderer.save(args.checkpoint)
    if not args.quiet:
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def cmd_parity(args) -> int:
    if torch.device(args.device).type != "cuda":
        print(f"parity holds the CUDA kernels against their plain versions "
              f"and needs a CUDA device, not {args.device!r}",
              file=sys.stderr)
        return 2
    width, height = args.size
    scene = get_scene(args.scene, width, height)
    images = {}
    for tracer in ("cuda", "torch"):
        cfg = render_config(args, scene, tracer=tracer)
        images[tracer] = Renderer(scene, cfg, device=args.device).render(
            args.spp)
    err = image_io.rmse(images["cuda"], images["torch"])
    ok = err < PARITY_RMSE
    print(f"scene={args.scene} {width}x{height} spp={args.spp} cuda vs "
          f"torch tracer on {args.device}: RMSE={err:.3e} -> "
          f"{'PASS' if ok else 'FAIL'} (target < {PARITY_RMSE})")
    return 0 if ok else 1


def cmd_scenes(_args) -> int:
    for name in sorted(SCENES):
        print(name)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "render":
        return cmd_render(args)
    if args.command == "scenes":
        return cmd_scenes(args)
    if args.command == "parity":
        return cmd_parity(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
