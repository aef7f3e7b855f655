"""How ``correct`` is decided: the program's accumulated image against the
plain reference's, at a sample of pixels drawn from the seed.

After the window, the program's image holds the mean of its first N
samples at every pixel.  The reference (:mod:`bench_port.reference`)
traces samples 0 .. N-1 of each sampled pixel from the same scene arrays
and seed, and takes their mean in float64.  A pixel's gap is its largest
channel difference over the image's scale (the sampled reference pixels'
mean value).  The numbers are the gaps' median, mean and maximum; a
cell's check file (``bench_port/checks/<cell>.json``) names the ones held
and the limit of each, with the readings it was set from.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

__all__ = ["sample_pixels", "gap_numbers", "judge"]


def sample_pixels(seed: int, width: int, height: int, count: int) -> np.ndarray:
    """``count`` distinct flat pixel indices, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed % (1 << 64), 0x70697865]))
    n = width * height
    return np.sort(rng.choice(n, size=min(count, n), replace=False))


def gap_numbers(program: np.ndarray, reference: np.ndarray) -> Dict[str, float]:
    """The gap statistics of the program's pixels (P, 3) against the
    reference's; a non-finite program pixel makes every number inf."""
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    if not np.isfinite(program).all():
        return {"gap_median": math.inf, "gap_mean": math.inf,
                "gap_max": math.inf}
    scale = float(reference.mean())
    if not scale > 0.0:
        scale = 1.0
    gap = np.abs(program - reference).max(axis=1) / scale
    return {"gap_median": float(np.median(gap)),
            "gap_mean": float(gap.mean()),
            "gap_max": float(gap.max())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every held number finite and within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())
