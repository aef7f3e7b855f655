"""The benchmark's yardstick: the card's peaks and the least work of the
traversal passes, which the roofline readers divide by.

Peaks: HBM at 3.35 TB/s (the H100 SXM data sheet) and the FP32 issue
rate, 128 lanes an SM a clock times the SMs and the maximum SM clock of
the card the run is on (both read in the run).  Work: every traced ray's
input read once and its result written once, and one Moller-Trumbore
test (30 issue slots) a ray, the least any structure or kernel can do for
it.
"""

from __future__ import annotations

import subprocess

__all__ = ["HBM_BYTES_PER_S", "FP32_LANES_PER_SM", "card", "trace_least_s"]

HBM_BYTES_PER_S = 3.35e12
FP32_LANES_PER_SM = 128
# a closest ray: origin + direction in (24 B), t + triangle out (8 B);
# a shadow ray: origin + direction + max t in (28 B), one flag out (1 B)
CLOSEST_BYTES = 24 + 8
SHADOW_BYTES = 28 + 1
MT_ISSUE_SLOTS = 30


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def card() -> dict:
    """The card's name, power limit, SMs, maximum SM clock and FP32 issue
    rate (instructions a second), read now."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm") or "nan")
    return {"kind": torch.cuda.get_device_name(0),
            "power_limit_w": float(_smi("power.limit") or "nan"),
            "sms": sms, "max_sm_mhz": mhz,
            "issue_rate": sms * FP32_LANES_PER_SM * mhz * 1e6,
            "hbm_bytes_per_s": HBM_BYTES_PER_S}


def trace_least_s(closest_rays: float, shadow_rays: float, issue_rate: float,
                  hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """The least time the traversal passes of these rays can take."""
    bytes_ = closest_rays * CLOSEST_BYTES + shadow_rays * SHADOW_BYTES
    ops = (closest_rays + shadow_rays) * MT_ISSUE_SLOTS
    return max(bytes_ / hbm_bytes_per_s, ops / issue_rate)
