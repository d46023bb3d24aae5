"""The card: its published peaks, its name, power limit and memory peak.

The peaks are the benchmark's own copy of NVIDIA's data sheet (H100 SXM,
dense rates, 700 W), so that no change to the program moves the
yardstick. Every f32 product is held to 495 TFLOP/s, the dense TF32
rate of the tensor cores: the fastest at which any float32 product can
run on this card, so no f32-accurate scheme can read above it.
"""

from __future__ import annotations

import subprocess
from typing import Optional

import torch

PEAKS = {
    "H100": {"f32_product_flops": 495e12,   # dense TF32, tensor cores
             "hbm_bytes_per_s": 3.35e12},
}


def peaks(name: str) -> Optional[dict]:
    """The data sheet's peaks of the card called ``name``; None for a
    card (or the CPU) the table does not hold."""
    for key, p in PEAKS.items():
        if key in name:
            return p
    return None


def least_seconds(ops: float, nbytes: float, peak: dict) -> float:
    """The roofline's least time: the larger of the operations at the f32
    product rate and the bytes at the memory's rate."""
    return max(ops / peak["f32_product_flops"],
               nbytes / peak["hbm_bytes_per_s"])


def power_limit() -> str:
    """``nvidia-smi``'s power limit of card 0, or why it is unknown."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def describe(device: torch.device, count: int) -> dict:
    """The result line's ``device`` block (without the trace's times)."""
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
