"""The plain reference path tracer: the image the benchmark holds the
program's accumulated image against, at a sample of its pixels.

Each path follows the reference shader (JaapWijnen/metal-raytracing
``Raytracing.metal:156-405``): a jittered camera ray, then per bounce the
closest hit (the path ends on a miss), the interpolated shading normal,
one uniformly chosen light sampled (area: a point on its rectangle with
the emitter's cosine; spot: inside its cone; 1/d^2 falloff), a shadow ray
from 1e-3 off the surface, and a cosine-weighted bounce.  The extensions
of the path tracer's configuration: ``enable_emission`` adds the hit
material's Ke, ``enable_specular`` picks per path between the diffuse
lobe and a Phong lobe about the mirror direction by Ks against Kd;
``env_map`` adds, for a ray that leaves the scene, the throughput times
the environment map's texel in its direction; ``enable_refraction`` sends
the share ``1 - d`` of the rays that hit a dielectric (Ni > 0, d < 1)
through it by Snell's law, or off it by Schlick's Fresnel term or total
internal reflection.  The Halton dimensions are the shader's, the
extensions' past them.  A pixel's value is the mean over its samples
``0 .. N-1``, summed in float64.

``rnd`` is applied to every stored intermediate: identity for the float32
reference, a rounding for the lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .sampling import (PRIMES, align_with_normal, bounce_dim,
                       cosine_hemisphere, halton, norm, pixel_offsets)
from .scene import AREA, POINT, SPOT, SUN, RefScene

__all__ = ["render_pixels", "trace_paths", "tf32"]

# The reference follows the RenderConfig fields that change the image
# (max_bounces, enable_specular, enable_emission, env_map,
# enable_refraction, seed, rand_offset_bits; the program's defaults 3,
# off, off, off, off, 0, 20); the rest of a traffic's fields (tracer,
# compaction, sort keys, dispatch) permute or schedule the same work.  It
# does not model textures (texture coordinates, map_Kd images), and
# refuses a traffic that turns them on.


def _ident(x):
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (to nearest, ties to
    even), in float32: the control's rounding of each stored value."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _normalize(v, rnd):
    return rnd(v / torch.clamp(norm(v), min=1e-20))


def _dot(a, b):
    return (a * b).sum(-1)


def _last_dim(opts: dict) -> int:
    """The highest Halton dimension a path of ``opts`` draws: the light
    and bounce draws of the last bounce, then past all of them one
    dimension a bounce for the lobe choice and, with refraction, one for
    transmission and one for the Fresnel choice."""
    b = opts.get("max_bounces", 3)
    if opts.get("enable_refraction"):
        return bounce_dim(b, 0) + 3 * b - 1
    if opts.get("enable_specular"):
        return bounce_dim(b, 0) + b - 1
    return bounce_dim(b - 1, 4)


def env_texel(env, d, rnd):
    """The texels of the lat-long map ``env`` (He, We, 3) in directions
    ``d``: u = atan2(d_x, -d_z) / 2 pi + 1/2 across, v = acos(d_y) / pi
    down, each truncated to its texel and held inside the map."""
    he, we = env.shape[0], env.shape[1]
    u = rnd(torch.atan2(d[:, 0], -d[:, 2]) / (2.0 * math.pi) + 0.5)
    v = rnd(torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi)
    xi = torch.clamp((u * we).to(torch.int64), 0, we - 1)
    yi = torch.clamp((v * he).to(torch.int64), 0, he - 1)
    return env[yi, xi]


def sample_light(s: RefScene, li, u, pos, rnd):
    """(direction, color, distance) toward a point of light ``li``."""
    lt = s.lights
    kind = lt["type"][li]
    lpos, lcol = lt["position"][li], lt["color"][li]
    lfwd, ldir = lt["forward"][li], lt["direction"][li]
    u2 = u * 2.0 - 1.0
    area_pt = lpos + lt["right"][li] * u2[:, 0:1] + lt["up"][li] * u2[:, 1:2]
    target = torch.where((kind == AREA)[:, None], area_pt, lpos)
    to = rnd(target - pos)
    dist = rnd(norm(to)[:, 0])
    inv = 1.0 / torch.clamp(dist, min=1e-3)
    direction = rnd(to * inv[:, None])
    fall = (inv * inv)[:, None]
    area_col = lcol * fall * torch.clamp(_dot(-direction, lfwd), 0.0,
                                         1.0)[:, None]
    cone = ldir / torch.clamp(norm(ldir), min=1e-12)
    inside = _dot(-direction, cone) > torch.cos(lt["cone_angle"][li])
    spot_col = torch.where(inside[:, None], lcol * fall,
                           torch.zeros_like(lcol))
    color = torch.zeros_like(lcol)
    color = torch.where((kind == AREA)[:, None], area_col, color)
    color = torch.where((kind == SPOT)[:, None], spot_col, color)
    color = torch.where((kind == POINT)[:, None], lcol * fall, color)
    color = torch.where((kind == SUN)[:, None], lcol, color)
    sun = kind == SUN
    direction = torch.where(sun[:, None], -cone, direction)
    dist = torch.where(sun, torch.full_like(dist, float("inf")), dist)
    return direction, rnd(color), dist


def trace_paths(s: RefScene, tracer, opts: dict, px, py, idx,
                rnd=_ident) -> torch.Tensor:
    """(R, 3) float32 radiance of one path each for pixels (px, py) at
    Halton indices ``idx`` (pixel offset + sample index).  ``tracer`` has
    ``closest(o, d)`` and ``any(o, d, t_max)`` (:mod:`.tracer`)."""
    n = idx.shape[0]
    dev = idx.device
    w, h = s.width, s.height
    bounces = opts.get("max_bounces", 3)
    lcount = int(s.lights["type"].shape[0])
    jx, jy = halton(idx, 0), halton(idx, 1)
    ux = (px + jx) / w * 2.0 - 1.0
    uy = (py + jy) / h * 2.0 - 1.0
    d = _normalize(ux[:, None] * s.cam_right + uy[:, None] * s.cam_up
                   + s.cam_forward, rnd)
    o = rnd(s.cam_pos.expand(n, 3))
    color = torch.ones((n, 3), device=dev)
    accum = torch.zeros((n, 3), device=dev)
    ids = torch.arange(n, device=dev)  # the paths still alive
    env = s.env if opts.get("env_map") else None
    for b in range(bounces):
        t, tri, u, v = tracer.closest(o, d)
        keep = tri >= 0
        if env is not None and not bool(keep.all()):
            out = ~keep
            accum[ids[out]] = rnd(accum[ids[out]]
                                  + color[out] * env_texel(env, d[out], rnd))
        ids, o, d, color, t, tri, u, v = (x[keep] for x in
                                          (ids, o, d, color, t, tri, u, v))
        if ids.numel() == 0:
            break
        i = idx[ids]
        pos = rnd(o + d * t[:, None])
        w0 = (1.0 - u - v)[:, None]
        ns = _normalize(s.n0[tri] * w0 + s.n1[tri] * u[:, None]
                        + s.n2[tri] * v[:, None], rnd)
        mid = s.mat[tri]
        kd = s.kd[mid]
        if opts.get("enable_emission"):
            accum[ids] = rnd(accum[ids] + color * s.ke[mid])
        lu = halton(i, bounce_dim(b, 0))
        li = torch.clamp((lu * lcount).to(torch.int64), max=lcount - 1)
        r_light = torch.stack([halton(i, bounce_dim(b, 1)),
                               halton(i, bounce_dim(b, 2))], -1)
        ldir, lcol, ldist = sample_light(s, li, r_light, pos, rnd)
        ndotl = torch.clamp(_dot(ns, ldir), 0.0, 1.0)
        lcolor = rnd(lcol * ndotl[:, None] * lcount)
        dcolor = rnd(color * kd)
        shadow = norm(lcolor)[:, 0] > 1e-4
        so = rnd(pos + ns * 1e-3)
        occluded = torch.zeros_like(shadow)
        sel = shadow.nonzero()[:, 0]
        if sel.numel():
            occluded[sel] = tracer.any(so[sel], ldir[sel], ldist[sel] - 1e-3)
        visible = shadow & ~occluded
        nee = lcolor * dcolor
        if opts.get("enable_refraction"):
            # a dielectric's diffuse layer carries the share d
            glass = (s.dissolve[mid] < 1.0) & (s.ni[mid] > 0.0)
            nee = rnd(nee * torch.where(glass, s.dissolve[mid], 1.0)[:, None])
        accum[ids] = rnd(accum[ids] + torch.where(
            visible[:, None], nee, torch.zeros_like(dcolor)))
        r_b = torch.stack([halton(i, bounce_dim(b, 3)),
                           halton(i, bounce_dim(b, 4))], -1)
        d_next = rnd(align_with_normal(cosine_hemisphere(r_b), ns))
        color_next = dcolor
        if opts.get("enable_specular"):
            ks = s.ks[mid]
            shin = s.ns[mid][:, None]
            kd_max, ks_max = kd.amax(-1), ks.amax(-1)
            p_spec = ks_max / torch.clamp(kd_max + ks_max, min=1e-6)
            ext = 2 + 5 * bounces + b
            take = (halton(i, ext) < p_spec) & (ks_max > 0.0)
            refl = d - 2.0 * _dot(d, ns)[:, None] * ns
            cos_a = r_b[:, 1:2] ** (1.0 / (shin + 1.0))
            sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
            phi = 2.0 * math.pi * r_b[:, 0:1]
            lobe = torch.cat([sin_a * torch.cos(phi), cos_a,
                              sin_a * torch.sin(phi)], -1)
            d_spec = align_with_normal(lobe, refl)
            d_spec = torch.where((_dot(d_spec, ns) <= 0.0)[:, None], refl,
                                 d_spec)
            pc = torch.clamp(p_spec, 1e-6, 1.0 - 1e-6)[:, None]
            d_next = rnd(torch.where(take[:, None], d_spec, d_next))
            color_next = rnd(torch.where(take[:, None], color * ks / pc,
                                         color * kd / (1.0 - pc)))
        o_next = so
        if opts.get("enable_refraction"):
            o_next, d_next, color_next = _dielectric(
                s, mid, i, b, bounces, pos, d, ns, color, kd, o_next, d_next,
                color_next, rnd)
        o, d, color = o_next, d_next, color_next
    return accum


def _dielectric(s: RefScene, mid, i, b, bounces, pos, d, ns, color, kd,
                o_next, d_next, color_next, rnd):
    """The continuation of the paths that hit a dielectric and draw
    transmission (Halton dimension ``2 + 6B + b`` >= its d): reflected
    about the normal that faces the ray with Schlick's probability
    (dimension ``2 + 7B + b``; always under total internal reflection),
    else refracted by Snell's law; tinted by the glass's Kd where it has
    one; leaving 1e-3 off the surface on the side it goes to.  The other
    paths keep (``o_next``, ``d_next``, ``color_next``)."""
    ext = bounce_dim(bounces, 0) + b
    ior, dis = s.ni[mid], s.dissolve[mid]
    through = ((dis < 1.0) & (ior > 0.0)
               & (halton(i, ext + bounces) >= dis))
    inside = _dot(d, ns) > 0.0  # a back-face hit: the ray leaves the glass
    n_eff = rnd(torch.where(inside[:, None], -ns, ns))
    ci = rnd(torch.clamp(-_dot(d, n_eff), 0.0, 1.0))
    ior = torch.clamp(ior, min=1.0 + 1e-6)
    eta = torch.where(inside, ior, 1.0 / ior)
    sin2_t = rnd(eta * eta * (1.0 - ci * ci))
    tir = sin2_t > 1.0
    f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    fresnel = rnd(torch.where(tir, 1.0, f0 + (1.0 - f0) * (1.0 - ci) ** 5))
    mirror = halton(i, ext + 2 * bounces) < fresnel
    d_refl = _normalize(d + 2.0 * ci[:, None] * n_eff, rnd)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    d_refr = _normalize(eta[:, None] * d + (eta * ci - cos_t)[:, None]
                        * n_eff, rnd)
    d_glass = torch.where(mirror[:, None], d_refl, d_refr)
    o_glass = rnd(pos + torch.where(mirror[:, None], n_eff, -n_eff) * 1e-3)
    tint = torch.where((kd.amax(-1) > 1e-4)[:, None], kd, 1.0)
    sel = through[:, None]
    return (torch.where(sel, o_glass, o_next),
            torch.where(sel, d_glass, d_next),
            rnd(torch.where(sel, color * tint, color_next)))


def render_pixels(s: RefScene, tracer, opts: dict, pixels, samples: int,
                  ray_budget: int = 262144, rnd=_ident) -> np.ndarray:
    """(P, 3) float64: the mean over samples 0 .. ``samples``-1 of each
    flat pixel index in ``pixels`` (row-major), ``ray_budget`` paths at a
    time."""
    if opts.get("enable_textures"):
        raise NotImplementedError(
            "the reference does not model enable_textures: the benchmark's "
            "OBJ files carry no texture coordinates and no map_Kd image")
    if _last_dim(opts) >= len(PRIMES):
        raise ValueError(
            f"max_bounces {opts.get('max_bounces', 3)} with these extensions "
            f"draws Halton dimension {_last_dim(opts)}; the table of primes "
            f"holds dimensions 0-{len(PRIMES) - 1}")
    dev = s.v0.device
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    off = torch.as_tensor(pixel_offsets(opts.get("seed", 0),
                                        s.width * s.height,
                                        opts.get("rand_offset_bits", 20)),
                          device=dev)[pix]
    total = torch.zeros((pix.shape[0], 3), dtype=torch.float64, device=dev)
    per = max(1, ray_budget // max(1, pix.shape[0]))
    for f0 in range(0, samples, per):
        fr = torch.arange(f0, min(samples, f0 + per), device=dev,
                          dtype=torch.int32)
        idx = (off[:, None].to(torch.int32) + fr[None]).reshape(-1)
        rep = fr.shape[0]
        px = (pix % s.width).to(torch.float32).repeat_interleave(rep)
        py = (pix // s.width).to(torch.float32).repeat_interleave(rep)
        rad = trace_paths(s, tracer, opts, px, py, idx, rnd)
        total += rad.reshape(pix.shape[0], rep, 3).double().sum(1)
    return (total / samples).cpu().numpy()
