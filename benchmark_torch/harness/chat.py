"""A chat cell: set up the served path, drive the window, read the metrics,
then hold a sample of the answers against the reference."""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import json
import os
import shutil
import sys
import time
from types import SimpleNamespace

from . import arith, check, serve, trace, traffic
from .common import BENCH_DIR, CACHE, Cell, set_cache_env
from .corpus import Texts, ensure_corpus
from .families import family
from .load import Load, message, sleep_until
from .probe import Probe
from .weights import make_weights, role_seed

DRAIN_S = 60.0
SAMPLE = 48


def tiny_config(config: dict) -> dict:
    """The configuration at the port's test sizes, for a rehearsal on the
    CPU: each role's tiny model (its family's ``TINY``), a few thousand
    leaves as wide as the tiny embedder, and an IVF threshold under them
    where the configuration's tier is IVF."""
    c = copy.deepcopy(config)
    for role in ("embedder", "reranker"):
        c[role].update(family(config[role]).TINY[role])
    ivf = config["n_leaves"] >= config["serving"]["engine_ivf_threshold"]
    c["n_leaves"] = c["corpus"]["n_leaves"] = 8192 if ivf else 4096
    c["corpus"]["dim"] = c["embedder"]["hidden_size"]
    if ivf:
        c["serving"].update(engine_ivf_threshold=4096, engine_ivf_clusters=64, engine_ivf_nprobe=8)
    return c


def is_ivf(config: dict) -> bool:
    return config["n_leaves"] >= config["serving"]["engine_ivf_threshold"]


def seat_weights(config: dict, seed: int) -> None:
    """The program loads a model without a checkpoint through
    ``Embedder.random_init`` / ``Reranker.random_init``; these give it the
    benchmark's weights instead (drawn from ``seed``), seated by the role's
    family through the program's own loader. The architecture the program
    serves must be the configuration's."""
    from tensortruth_tpu_torch.models.embedder import Embedder
    from tensortruth_tpu_torch.models.reranker import Reranker

    def make(role: str):
        m = config[role]
        fam = family(m)

        def random_init(cls, cfg, tokenizer, device, dtype=None, seed_=0, **kw):
            fam.check_program(m, role, cfg)
            hf = make_weights(m, role_seed(seed, role), device)
            model = fam.program_model(cfg, hf, device, dtype)
            del hf
            return cls(model, tokenizer, **kw)
        return classmethod(random_init)

    Embedder.random_init = make("embedder")
    Reranker.random_init = make("reranker")


def lower_ivf_threshold(config: dict) -> None:
    """For a CPU rehearsal only: the engine's IVF placement at the tiny
    configuration's threshold, clusters and probes (at full size the engine
    keeps its own defaults, which the configuration states)."""
    from tensortruth_tpu_torch.retrieval.engine import MultiIndexEngine

    s = config["serving"]
    init = MultiIndexEngine.__init__

    def patched(self, *a, **kw):
        kw.setdefault("ivf_threshold", s["engine_ivf_threshold"])
        kw.setdefault("ivf_clusters", s["engine_ivf_clusters"])
        kw.setdefault("ivf_nprobe", s["engine_ivf_nprobe"])
        init(self, *a, **kw)

    MultiIndexEngine.__init__ = patched


def load_metric(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card(device: str) -> dict:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def power_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi unavailable"
    return out


@contextlib.contextmanager
def served(cell: Cell, seed: int, tiny: bool = False, fault: str | None = None):
    """The program's app running in this process over the configuration's
    module, with the benchmark's weights from ``seed`` and its probe
    installed, and the load process (the fake Ollama and the WebSocket
    clients) connected to it."""
    config = tiny_config(cell.config) if tiny else cell.config
    device = "cpu" if tiny else "cuda"
    set_cache_env()
    data_dir = CACHE / "app" / cell.name
    shutil.rmtree(data_dir, ignore_errors=True)
    data_dir.mkdir(parents=True)
    indexes_dir, corpus_s = ensure_corpus(config, device, ".tiny" if tiny else "")
    os.environ["TENSOR_TRUTH_TPU_DATA_DIR"] = str(data_dir)
    os.environ["TENSOR_TRUTH_TPU_INDEXES_DIR"] = str(indexes_dir)
    seat_weights(config, seed)
    if tiny:
        lower_ivf_threshold(config)
    probe = Probe(fault).install()
    from tensortruth_tpu_torch.core.providers import ProviderRegistry, clear_llm_cache
    from tensortruth_tpu_torch.server.app import create_app

    load = Load()
    server = None
    ProviderRegistry.reset_instance()
    clear_llm_cache()
    try:
        serve.write_config(config, f"http://127.0.0.1:{load.ollama_port}", tiny)
        app = create_app(device=device)
        server = serve.ThreadedApp(app).start()
        load.ask(cmd="connect", base=f"http://127.0.0.1:{server.port}", module=config["corpus"]["module"],
                 per_session=cell.traffic["messages_per_session"])
        yield SimpleNamespace(config=config, device=device, app=app, rag=app["services"].rag_service,
                              probe=probe, texts=Texts(config["corpus"]), corpus_s=corpus_s, load=load)
    finally:
        load.close()
        if server is not None:
            server.stop()
        ProviderRegistry.reset_instance()
        clear_llm_cache()


def run(cell: Cell, seed: int, seconds: float, tracing: bool, t_start: float, tiny: bool = False,
        fault: str | None = None) -> dict:
    import torch
    from tensortruth_tpu_torch.models.manager import ModelManager

    spec = cell.traffic
    with served(cell, seed, tiny, fault) as sv:
        config, device, probe, rag, app, corpus_s = sv.config, sv.device, sv.probe, sv.rag, sv.app, sv.corpus_s
        out = _drive(sv, spec, seed, seconds, tracing, t_start)
        placement = dict(rag.engine.retriever.placement_seconds) if rag.engine is not None else {}
    dev = card(device)

    ctx = SimpleNamespace(cell=cell.name, config=config, traffic=spec, arith=arith, probe=probe,
                          placement_seconds=placement, corpus_write_s=corpus_s, device=device, **out)
    names = [m["name"] for m in (cell.per_layer if tracing else cell.end_to_end)]
    metrics = {}
    for name in names:
        unit = next(m["unit"] for m in cell.per_layer + cell.end_to_end if m["name"] == name)
        value = load_metric(name).read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}

    # Free the program's state before the reference: its peak is read.
    records = [check.Record(m.text, m.sources, probe.candidates.get(m.text)) for m in out["counted"] if m.ok]
    failed = [m for m in out["counted"] if not m.ok]
    probe.uninstall()
    rag.clear_engines()
    ModelManager.get_instance().unload_all()
    del app, rag, probe, ctx, sv
    out.pop("counted")
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    ref_mod = check.load_reference(config)
    chosen = check.sample(records, seed, SAMPLE, ref_mod.n_tokens)
    missing = sum(r.candidates is None for r in chosen)
    t_ref = time.perf_counter()
    ref = check.Reference(config, seed, device)
    numbers, seen = check.compare(chosen, ref, exact_search=not is_ivf(config))
    del ref
    ok, shown = check.verdict(numbers, config.get("limits", {}))
    correct = ok and not failed and not missing and bool(records)
    result = {"correct": correct, "attempted": len(records) + len(failed), "failed": len(failed),
              "metrics": metrics, "device": dev}
    if tracing and out.get("trace"):
        result["device"].update(busy_s=out["trace"]["busy_s"], window_s=out["trace"]["window_s"])
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"], "idle_gaps": out["trace"]["idle_gaps"]}
    result["checks"] = shown
    info = {"seed": seed, "cell": cell.name, "setup_s": out["setup_s"], "corpus_write_s": corpus_s,
            "lateness_ms": out.get("lateness_ms"), "batcher": out["batcher"], "placement_s": placement,
            "answered": out["answered"], "answered_span_s": out["answered_span_s"],
            "p50_ms": arith.percentile(out["latencies_ms"], 50) if out["latencies_ms"] else None,
            "p95_ms": arith.percentile(out["latencies_ms"], 95) if out["latencies_ms"] else None,
            "seen": seen, "missing_candidates": missing, "reference_s": time.perf_counter() - t_ref,
            "first_failures": [m.error for m in failed[:3]], "card": power_line() if device == "cuda" else "cpu"}
    print("info " + json.dumps(info, default=str), file=sys.stderr)
    check.print_checks(shown)
    return result


def window_size(spec, seconds) -> int:
    """How many messages the window's traffic draws lengths for."""
    if spec["generator"] == "open_loop":
        return max(1, int(round(spec["rate_per_s"] * seconds)))
    return spec["query_pool"]


def fill(load, spec, n_window: int) -> None:
    """Open the sessions the window starts with: for an open loop every
    session its messages need, for a closed loop one a client."""
    if spec["generator"] == "open_loop":
        load.ask(cmd="fill", n=min(n_window, -(-n_window // spec["messages_per_session"]) + 16))
    else:
        load.ask(cmd="fill", n=spec["sessions"])


def warm_up(load, spec, texts, n_window: int) -> None:
    """The first message, the window's longest, loads the engine (index,
    placement, weights); then bursts of every batch size meet each shape
    the window will use."""
    warm_words = traffic.lengths(spec, max(256, n_window), 0)
    warm_words.insert(0, warm_words.pop(warm_words.index(max(warm_words))))
    first = load.burst(traffic.queries(texts.pool, warm_words[:1], 0, "warm"))
    if not first[0].ok:
        raise RuntimeError(f"the first message failed: {first[0].error}")
    at = 1
    for size in traffic.WARMUP_BURSTS:
        words = sorted(warm_words[at: at + size], reverse=(size % 2 == 0))
        bad = [m.error for m in load.burst(traffic.queries(texts.pool, words, at, "warm")) if not m.ok]
        if bad:
            raise RuntimeError(f"warm-up message failed: {bad[0]}")
        at += size


def open_loop(load, spec, texts, seed, seconds, tag="q", on_start=None):
    """The open loop's window: (messages, lateness, latencies in ms). A
    failed message counts as waited for until the drain deadline."""
    offsets = traffic.arrivals(spec, seconds, seed)
    qs = traffic.queries(texts.pool, traffic.lengths(spec, len(offsets), seed), seed, tag)
    load.send(cmd="open_loop", texts=qs, offsets=offsets, drain_s=DRAIN_S)
    start = load.read()["window_start"]
    if on_start is not None:
        on_start(start)
    res = load.read()
    msgs = [message(d) for d in res["messages"]]
    late = res["late"]
    lateness = {"p50": arith.percentile(late, 50) * 1e3, "p99": arith.percentile(late, 99) * 1e3,
                "max": max(late) * 1e3}
    deadline = msgs[-1].due + DRAIN_S
    lat = [((m.sources_at if m.ok else deadline) - m.due) * 1e3 for m in msgs]
    return msgs, lateness, lat, start


def closed_loop(load, spec, texts, seed, seconds, on_start=None):
    """The closed loop's window: (messages counted, answered inside it)."""
    qs = traffic.queries(texts.pool, traffic.lengths(spec, spec["query_pool"], seed), seed)
    load.send(cmd="closed_loop", texts=qs, sessions=spec["sessions"], ramp_s=spec["ramp_s"], seconds=seconds,
              drain_s=DRAIN_S)
    start = load.read()["window_start"]
    if on_start is not None:
        on_start(start)
    msgs = [message(d) for d in load.read()["messages"]]
    counted = [m for m in msgs if 0 <= m.due < seconds or (m.ok and 0 <= m.sources_at < seconds)]
    answered = sum(1 for m in msgs if m.ok and 0 <= m.sources_at < seconds)
    return counted, answered, start


def _drive(sv, spec, seed, seconds, tracing, t_start) -> dict:
    """Set-up through the served path, then the window."""
    load, probe = sv.load, sv.probe
    n = window_size(spec, seconds)
    warm_up(load, spec, sv.texts, n)
    fill(load, spec, n)
    status0 = load.ask(cmd="status")
    prof_box = {}
    if tracing:
        span_s = min(spec.get("trace_s", 4.0), seconds / 3)
        path = CACHE / "trace" / "window.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.unlink(missing_ok=True)
        prof = trace.prepare(path)

    def on_start(start: float) -> None:
        """With a trace: record the window's last ``span_s`` seconds (the
        profiler's stop holds the host, so nothing of the window follows)."""
        prof_box["start"] = start
        if not tracing:
            return
        sleep_until(start + seconds - span_s)
        prof.step()
        probe.tracing = True
        prof_box["t0"] = time.perf_counter()
        time.sleep(span_s)
        prof_box["t1"] = time.perf_counter()
        probe.tracing = False
        prof.step()
        prof.stop()

    if spec["generator"] == "open_loop":
        counted, lateness, lat, start = open_loop(load, spec, sv.texts, seed, seconds, on_start=on_start)
        answered = sum(m.ok for m in counted)
        # The window's messages took until their last answer, or the window's end where that came first.
        answered_span = max([seconds] + [m.sources_at for m in counted if m.ok])
    else:
        counted, answered, start = closed_loop(load, spec, sv.texts, seed, seconds, on_start=on_start)
        lat, lateness, answered_span = [], None, None
    status1 = load.ask(cmd="status")
    out = {"setup_s": start - t_start, "window_s": seconds, "latencies_ms": lat, "answered": answered,
           "answered_span_s": answered_span,
           "counted": counted, "lateness_ms": lateness, "batcher": {"before": status0, "after": status1},
           "trace": None, "trace_t0": prof_box.get("t0"), "trace_t1": prof_box.get("t1")}
    if lateness is not None:
        print("lateness " + json.dumps(lateness), file=sys.stderr, flush=True)
    if "t0" in prof_box:
        path = CACHE / "trace" / "window.json"
        out["trace"] = trace.reduce(path, prof_box["t1"] - prof_box["t0"])
        path.unlink()
    return out
