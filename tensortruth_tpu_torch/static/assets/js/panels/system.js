// System panel (reference components/status/*): backend/devices/RAM,
// loaded embedder/reranker/engine, LLM runtime reachability + unload,
// engine restart, JAX profiler control, background tasks.

import {listTasks} from "../api/tasks.js";
import {
  profileStart, profileStop, ragStatus, restartEngine, runtimeLoad,
  runtimeStatus, runtimeUnload, systemDevices, systemMemory, unloadModels,
} from "../api/system.js";
import {$, el, toast} from "../lib/dom.js";
import {rowItem} from "../views/manage.js";

const gb = (b) => (b / 1024 / 1024 / 1024).toFixed(1);

// Re-entrancy guard: a slow runtime probe can push one load past the 15 s
// poll tick; overlapping passes would interleave innerHTML resets and
// double-append rows.
let panelLoading = false;

// Per-device memory cards with usage bars (reference
// components/status/MemoryMonitor.tsx + SystemStatusPanel device grid):
// HBM in use vs limit per accelerator, plus a host-RAM card.
function renderDeviceCards(mem, devices) {
  const box = $("devices-cards"); box.innerHTML = "";
  const card = (title, used, limit, pct, extra) => {
    const c = el("div", "dev-card");
    c.appendChild(el("div", "dev-title", title));
    c.appendChild(el("div", "dev-nums",
      used != null && limit
        ? `${gb(used)} / ${gb(limit)} GB` + (extra ? ` · ${extra}` : "")
        : extra || "—"));
    const bar = el("div", "mem-bar");
    const fill = el("div", "", "");
    fill.style.width = `${Math.min(100, pct || 0)}%`;
    if ((pct || 0) > 90) fill.style.background = "var(--err)";
    bar.appendChild(fill);
    c.appendChild(bar);
    return c;
  };
  const kinds = new Map(
    (devices.devices || []).map((d, i) => [i, d.kind || d.platform || "device"]));
  (mem.devices || []).forEach((d, i) => {
    const pct = d.bytes_in_use != null && d.bytes_limit
      ? 100 * d.bytes_in_use / d.bytes_limit : 0;
    box.appendChild(card(
      `${kinds.get(i) || d.kind || d.platform || "device"} ${i}`,
      d.bytes_in_use, d.bytes_limit, pct,
      d.peak_bytes_in_use != null ? `peak ${gb(d.peak_bytes_in_use)} GB` : ""));
  });
  if (mem.ram && mem.ram.total) {
    box.appendChild(card("host RAM", mem.ram.total - mem.ram.available,
                         mem.ram.total, mem.ram.percent));
  }
}

export async function loadSystemPanel() {
  if (panelLoading) return;
  panelLoading = true;
  try {
    await loadSystemPanelOnce();
  } finally {
    panelLoading = false;
  }
}

async function loadSystemPanelOnce() {
  const kv = $("system-kv"); kv.innerHTML = "";
  const put = (k, v) => {
    kv.appendChild(el("div", "k", k));
    kv.appendChild(el("div", "", typeof v === "string" ? v : JSON.stringify(v)));
  };
  try {
    const [mem, devices, rag] = await Promise.all([
      systemMemory(), systemDevices(), ragStatus(),
    ]);
    renderDeviceCards(mem, devices);
    put("backend", devices.backend);
    put("embedder", rag.embedder ? `${rag.embedder.key[0]} (${rag.embedder.param_gb} GB)` : "not loaded");
    put("reranker", rag.reranker ? `${rag.reranker.key[0]} (${rag.reranker.param_gb} GB)` : "not loaded");
    put("engine", rag.engine
      ? `loaded: ${(rag.engine.modules || []).join(", ") || "scope docs"} (${rag.engine.n_chunks} chunks)`
      : "not loaded");
  } catch (e) { put("error", String(e)); }
  const rl = $("runtimes-list"); rl.innerHTML = "";
  for (const [name, path] of [["Ollama", "ollama"], ["llama.cpp", "llama-cpp"]]) {
    try {
      const st = await runtimeStatus(path);
      // Ollama reports {reachable, models, running: [names]}; llama.cpp
      // reports {running: bool, models} with no `reachable` key
      // (server/routes/system.py llama_cpp_status).
      const up = st.reachable !== undefined ? st.reachable : !!st.running;
      // "Unload all" only where per-model unloads exist to fan out to
      // (Ollama's /api/ps names); a model-less unload is a server-side 422
      const residentNames = Array.isArray(st.running) ? st.running : [];
      const row = rowItem(name,
        up ? `reachable · ${(st.models || st.loaded || []).length ?? 0} models`
           : `unreachable${st.error ? " · " + st.error : ""}`,
        up && residentNames.length ? [["Unload all", "", async () => {
          for (const m of residentNames)
            await runtimeUnload(path, {model: m}).catch(() => {});
          loadSystemPanel();
        }]] : []);
      row.insertBefore(el("span", "badge" + (up ? " on" : ""), up ? "up" : "down"),
                       row.children[1]);
      rl.appendChild(row);
      // per-model load/unload actions (reference useModelActions +
      // ModelSelectContent rows). Ollama lists model NAMES with a
      // `running` names array (/api/ps); llama.cpp lists
      // {id, status, display_name} objects with `running` as a BOOLEAN —
      // residency comes from the per-entry status there, and API calls
      // must carry the real `id` (display_name is a lossy rendering the
      // server cannot reverse).
      const resident = new Set(Array.isArray(st.running) ? st.running : []);
      const addModelRow = (modelId, label, isUp) => {
        const mrow = rowItem(label,
          isUp ? "resident in runtime memory" : "available",
          [isUp
            ? ["Unload", "", async () => {
                const r = await runtimeUnload(path, {model: modelId})
                  .catch(e => ({error: String(e)}));
                if (r && (r.error || r.success === false))
                  toast(`unload failed: ${r.error || r.message}`, true);
                loadSystemPanel();
              }]
            : ["Load", "", async ev => {
                ev.target.textContent = "loading…";
                ev.target.disabled = true;
                const r = await runtimeLoad(path, {model: modelId})
                  .catch(e => ({error: String(e)}));
                if (r && (r.error || r.success === false))
                  toast(`load failed: ${r.error || r.message}`, true);
                loadSystemPanel();
              }]]);
        if (isUp) mrow.insertBefore(el("span", "badge on", "●"), mrow.children[1]);
        mrow.classList.add("nested");
        rl.appendChild(mrow);
      };
      const listed = new Set();
      for (const entry of Array.isArray(st.models) ? st.models : []) {
        const modelId = typeof entry === "string"
          ? entry : (entry.id || entry.name || "");
        const label = typeof entry === "string"
          ? entry : (entry.display_name || entry.id || entry.name || "");
        const isUp = resident.has(modelId) ||
          (typeof entry === "object" && entry.status === "loaded");
        listed.add(modelId);
        addModelRow(modelId, label, isUp);
      }
      // resident models missing from the tags list (removed-while-loaded,
      // ps/tags skew) still need an Unload affordance
      for (const m of resident)
        if (!listed.has(m)) addModelRow(m, m, true);
    } catch (e) {
      rl.appendChild(rowItem(name, "status error: " + e, []));
    }
  }
  const tl = $("tasks-list"); tl.innerHTML = "";
  const tasks = await listTasks().catch(() => ({tasks: []}));
  if (!(tasks.tasks || []).length) tl.appendChild(el("div", "dim", "No background tasks."));
  for (const t of tasks.tasks || []) {
    tl.appendChild(rowItem(t.name || t.id,
      `${t.status}${t.stage ? " · " + t.stage : ""}${t.total ? ` (${t.progress}/${t.total})` : ""}`, []));
  }
}

export function wireSystemPanel() {
  $("engine-restart").onclick = async ev => {
    await restartEngine();
    ev.target.textContent = "Restarted ✓";
    setTimeout(() => ev.target.textContent = "Restart RAG engine", 1500);
  };
  $("models-unload").onclick = async () => {
    await unloadModels();
    loadSystemPanel();
  };
  $("system-refresh").onclick = () => loadSystemPanel();
  $("profile-start").onclick = async () => {
    const r = await profileStart();
    toast(r.status || r.error || "profiler started");
  };
  $("profile-stop").onclick = async () => {
    const r = await profileStop();
    toast(r.status || r.trace_dir || r.error || "profiler stopped");
  };
  // Live refresh while the panel is on screen (reference SystemStatusPanel
  // refetchInterval): skipped whenever manage is closed or another tab is
  // active, so the polling costs nothing in the common case.
  setInterval(() => {
    if ($("manage").style.display === "flex" &&
        $("panel-system").classList.contains("active"))
      loadSystemPanel();
  }, 15000);
}
