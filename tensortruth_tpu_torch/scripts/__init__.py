"""Measurement scripts that run on the card (``python -m tensortruth_tpu_torch.scripts.<name>``)."""

import subprocess
import time

import torch


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


def driver_device(device, tiny: bool):
    """The ``torch.device`` a driver runs on. A driver measures the card at
    full size; the CPU runs it only at its tiny size (``tiny=True``), and a
    CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this driver needs a CUDA card; torch.cuda.is_available() is False")
    if device.type != "cuda" and not tiny:
        raise ValueError(f"this driver runs on {device} only at its tiny size (tiny=True)")
    return device


def sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn, device, iters: int = 3, warmup: int = 1):
    """(mean s, min s, last output) of ``fn()``, each call waited for. The
    min is the floor under host noise; the mean absorbs its spikes."""
    for _ in range(warmup):
        fn()
        sync(device)
    best = float("inf")
    t0 = time.perf_counter()
    for _ in range(iters):
        t1 = time.perf_counter()
        out = fn()
        sync(device)
        best = min(best, time.perf_counter() - t1)
    return (time.perf_counter() - t0) / iters, best, out


def backend(device) -> str:
    """The name of the device a driver ran on: the card's, or ``cpu``."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
