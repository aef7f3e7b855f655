"""Headless CLI of the port: progressive render to PNG/HDR with checkpoints.

Usage:
    python -m metal_raytracing_tpu_torch render --scene dragon \
        --size 1024x1024 --spp 8 --out dragon.png
    python -m metal_raytracing_tpu_torch scenes

``--device`` defaults to ``cuda``; there is no silent fallback to the CPU
(pass ``--device cpu`` to render with the kernels' plain PyTorch versions).
The shading extensions of the JAX package's CLI (specular, emission,
textures, refraction, environment map) and its ``parity`` command are not
ported yet (ROADMAP.md), so ``--scene coatball`` renders the reference's
diffuse shading here.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .io import image as image_io
from .renderer import Renderer
from .scenes import SCENES, get_scene
from .types import RenderConfig


def _parse_size(s: str):
    w, _, h = s.partition("x")
    return int(w), int(h or w)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="metal_raytracing_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render a scene to an image")
    r.add_argument("--scene", default="dragon", choices=sorted(SCENES))
    r.add_argument("--size", type=_parse_size, default=(512, 512),
                   metavar="WxH")
    r.add_argument("--spp", type=int, default=4, help="samples per pixel")
    r.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    r.add_argument("--out", default="render.png")
    r.add_argument("--hdr-out", default=None,
                   help="also write linear HDR output")
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

    sub.add_parser("scenes", help="list available scenes")
    return p


def cmd_render(args) -> int:
    width, height = args.size
    scene = get_scene(args.scene, width, height)
    cfg = RenderConfig(width=width, height=height, spp=args.spp,
                       compaction=args.compaction, rank_trace=args.rank_trace)
    t0 = time.perf_counter()
    renderer = Renderer(scene, cfg, device=args.device)
    print(f"scene {scene.name}: {scene.triangle_count} triangles, "
          f"{renderer.spec.bvh.num_clusters} clusters, tracer "
          f"{renderer.tracer} on {renderer.device}, build "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)

    if (args.resume and args.checkpoint
            and os.path.exists(Renderer.checkpoint_path(args.checkpoint))):
        renderer.load(args.checkpoint)
        print(f"resumed at sample {renderer.frame_index}", file=sys.stderr)

    t0 = time.perf_counter()
    rays0 = renderer.total_closest_rays + renderer.total_shadow_rays
    while renderer.frame_index < args.spp:
        renderer.step(1)
        if args.save_every and renderer.frame_index % args.save_every == 0:
            image_io.write_png(args.out, renderer.image)
            if args.checkpoint:
                renderer.save(args.checkpoint)
        el = time.perf_counter() - t0
        rays = (renderer.total_closest_rays + renderer.total_shadow_rays
                - rays0)
        print(f"\rsample {renderer.frame_index}/{args.spp}  {el:.1f}s  "
              f"{rays / max(el, 1e-9) / 1e6:.1f} Mrays/s", end="",
              file=sys.stderr)
    print(file=sys.stderr)

    image_io.write_png(args.out, renderer.image)
    if args.hdr_out:
        image_io.write_hdr(args.hdr_out, renderer.image)
    if args.checkpoint:
        renderer.save(args.checkpoint)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


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
    return 1


if __name__ == "__main__":
    sys.exit(main())
