"""Measurement scripts that run on the card (``python -m tensortruth_tpu_torch.scripts.<name>``)."""

import subprocess


def card_line() -> str | None:
    """The first card's name and power limit as nvidia-smi reports them, or
    None where there is no nvidia-smi (a CPU run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout
    except FileNotFoundError:
        return None
    return out.strip().splitlines()[0]
