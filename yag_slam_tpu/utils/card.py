"""The card a measurement ran on, as nvidia-smi reports it."""
from __future__ import annotations

import subprocess


def card_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W" (one line per card), or None where
    there is no nvidia-smi.  A card below its maximum power limit runs
    slower under load, so every number measured on it carries this."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
