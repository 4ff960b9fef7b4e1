"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the 700 W limit); copied from ``chip_smoke.py``
l. 235-241. A card set below 700 W reaches less: the run prints its
power limit beside them."""

import subprocess

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
             "float64": 34e12}


def card():
    """``name, power.limit`` of the cards as ``nvidia-smi`` reads them
    (or why it could not)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return " | ".join(res.stdout.strip().splitlines()) or res.stderr.strip()
