"""The control of the comparison that decides ``correct``: the reference
put in the program's place, computed in the precision below the
configuration's float32, TF32 (every stored value of the path and of the
triangle test rounded to 10 mantissa bits, :func:`reference.tf32`), and
held against the float32 reference at the pixels and sample count of a
run.  Its readings set the upper end of each limit (PERF.md).

    python3 bench_port/control.py --workload <name> --samples <N> \\
        --seeds 11 12 13 [--device cuda]

prints one JSON line a seed: the gap numbers of the control.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# wide enough for the bins' boxes to hold the control's rounded hits
CONTROL_PAD = 0.05


def tf32_scene(rs):
    """The reference scene with every float tensor rounded to TF32."""
    import torch

    from bench_port.reference import tf32

    def rnd(x):
        return tf32(x) if torch.is_tensor(x) and x.is_floating_point() else x

    fields = {f.name: getattr(rs, f.name) for f in dataclasses.fields(rs)}
    fields = {k: ({n: rnd(t) for n, t in v.items()} if isinstance(v, dict)
                  else rnd(v)) for k, v in fields.items()}
    return type(rs)(**fields)


def control_numbers(cell_name: str, seed: int, samples: int, device: str,
                    width: int = None, height: int = None,
                    pixels: int = None) -> dict:
    """The control's gap numbers at the run's pixels and sample count."""
    from bench_port import check as CK
    from bench_port.harness import load_benchmark, resolve
    from bench_port.reference import Binned, build_scene, render_pixels, tf32
    from bench_port.scenegen import scene_inputs

    cell = resolve(load_benchmark(ROOT), cell_name)
    config = cell["config"]
    w, h = width or config["width"], height or config["height"]
    models, env_hdr = scene_inputs(config)
    rs = build_scene(config, models, device, w, h, env_hdr)
    pix = CK.sample_pixels(seed, w, h, pixels or cell["check"]["pixels"])
    opts = {**cell["traffic"]["render_config"], "seed": seed}
    ref = render_pixels(rs, Binned(rs.v0, rs.e1, rs.e2), opts, pix, samples)
    rq = tf32_scene(rs)
    ctl = render_pixels(rq, Binned(rq.v0, rq.e1, rq.e2, pad=CONTROL_PAD,
                                   rnd=tf32), opts, pix, samples, rnd=tf32)
    return CK.gap_numbers(ctl, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--samples", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control_numbers(args.workload, seed, args.samples,
                                  args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "samples": args.samples, "control": "tf32",
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
