"""Run one cell of the port's benchmark once and print its result.

    python3 bench_port/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number compared beside its limit); the numbers compared
are also the last lines of standard error.  With no CUDA device, or fewer
than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits with a code other than
0.  Build caches stay inside the checkout (``build/``).
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_port", sub)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from bench_port import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.resolve(bench, args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell needs {chips} CUDA device(s), this machine "
              f"has {have}; nothing is timed", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T0, device="cuda",
                              chips=chips, bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}; no result", file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"bench: {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
