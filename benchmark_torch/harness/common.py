"""Paths, the cell's definition and the environment every run shares.

A cell is found by name: ``BENCHMARK.json`` names its configuration and its
traffic mix, and each of those is a file of its own under
``benchmark_torch/configs`` and ``benchmark_torch/traffic``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CACHE = BENCH_DIR / ".cache"

# Published dense peaks of one H100 SXM (NVIDIA data sheet, no sparsity),
# at the card's full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_names: set[str] | None = None) -> bool:
    """Whether ``cell`` reports ``metric``: named in its ``workloads`` list,
    or, without one, every cell (a per-layer metric: every cell that reports
    the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_names is None:
        return True
    return metric["moves"] in e2e_names


def load_cell(name: str, bench_file: Path | None = None) -> Cell:
    bench = load_json(bench_file or ROOT / "BENCHMARK.json")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{work['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, e2e_names)]
    return Cell(name, work["config"], work["traffic"], int(work["chips"]), config, traffic, e2e, layer)


def set_cache_env() -> None:
    """Every build and kernel cache in fixed directories inside the
    checkout; the program's own kernel library already builds into
    ``tensortruth_tpu_torch/_build/``. No checkpoint is looked up outside
    the checkout: the benchmark supplies the weights."""
    for var, sub in (
        ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
        ("TRITON_CACHE_DIR", "triton"),
        ("CUDA_CACHE_PATH", "cuda_jit"),
        ("TENSOR_TRUTH_TPU_NATIVE_CACHE", "native"),
        ("HF_HUB_CACHE", "hf_hub_empty"),
        ("TENSOR_TRUTH_TPU_MODELS_DIR", "models_empty"),
    ):
        d = CACHE / sub
        d.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(d)
