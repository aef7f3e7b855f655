"""Why the port's coatball image is held against the JAX package's Pallas
tracer and not its exact BVH tracer (``tests/test_torch_shading.py``).

coatball's base stands on the floor, so with specular and emission on,
bounce rays from the glowing base meet the base's bottom and the floor at
one distance.  The packed key that the Pallas tracer and the port's kernels
share gives such a tie to the floor (the global set's seed wins ties); the
exact tracer may pick the base.  At 32x32, 1 sample, 3 bounces the port's
image (plain tracers) and the JAX package's own Pallas image (interpret
mode) leave the exact tracer's by the gate's max or more at the same
pixels, three of them (RMSE 3.87e-3 and 3.82e-3 against it); the port and
the Pallas image stay within the golden gate of each other.

From the repo's root, ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_shading_ties.py`` prints the three pairs' readings.
"""

import jax.numpy as jnp
import numpy as np

from metal_raytracing_tpu import renderer as JR
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (GATE_MAX, assert_image_gate,  # noqa: F401
                               build_both, few_torch_threads)

W = H = 32
FLAGS = dict(enable_specular=True, enable_emission=True)


def coatball_images(both):
    """{"JAX bvh", "JAX pallas", "port"} -> one sample of coatball."""
    jdata, jspec, tdata, tspec = both
    out = {}
    for tracer in ("bvh", "pallas"):
        cfg = JConfig(width=W, height=H, tracer=tracer, compaction=False,
                      **FLAGS)
        img, _ = JR.render_sample(jdata, jspec, cfg,
                                  JR.make_pixel_offsets(cfg), jnp.int32(0))
        out[f"JAX {tracer}"] = np.asarray(img)
    cfg = RenderConfig(width=W, height=H, **FLAGS)
    out["port"] = R.render_sample(tdata, tspec, cfg,
                                  R.make_pixel_offsets(cfg), 0)[0].numpy()
    return out


def beyond_gate(a, b):
    """(pixels (y, x) where ``a`` and ``b`` differ by the gate's max or more
    in some channel, RMSE, max difference)."""
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    per_px = diff.max(axis=-1)
    pixels = sorted((int(y), int(x))
                    for y, x in zip(*np.nonzero(per_px >= GATE_MAX)))
    return pixels, float(np.sqrt(np.mean(diff ** 2))), float(per_px.max())


def test_exact_tracer_breaks_the_ties_apart_from_both():
    shots = coatball_images(build_both("coatball", W, H))
    port_px, port_rmse, _ = beyond_gate(shots["port"], shots["JAX bvh"])
    jax_px, jax_rmse, _ = beyond_gate(shots["JAX pallas"], shots["JAX bvh"])
    msg = (f"beyond {GATE_MAX} of JAX bvh: port {port_px} (RMSE "
           f"{port_rmse:.3e}), JAX pallas {jax_px} (RMSE {jax_rmse:.3e})")
    assert port_px and port_px == jax_px, msg
    assert_image_gate(shots["port"], shots["JAX pallas"],
                      f"coatball {FLAGS} against JAX pallas")


if __name__ == "__main__":
    shots = coatball_images(build_both("coatball", W, H))
    for a, b in (("JAX pallas", "JAX bvh"), ("port", "JAX bvh"),
                 ("port", "JAX pallas")):
        px, err, worst = beyond_gate(shots[a], shots[b])
        print(f"coatball {W}x{H} {FLAGS}: {a} vs {b}: RMSE {err:.3e}, max "
              f"{worst:.3e}, pixels (y, x) beyond {GATE_MAX}: {px}")
