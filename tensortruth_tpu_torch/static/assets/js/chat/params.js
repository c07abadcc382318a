// Session-parameters drawer (reference SessionSettings component):
// read/patch per-session params, model autocomplete from every enabled
// provider's discovered models.

import {discoverModels} from "../api/providers.js";
import {getSession, patchSessionRaw} from "../api/sessions.js";
import {$, el} from "../lib/dom.js";
import {currentSessionId} from "../stores/session.js";

export function fillParamsDrawer(params) {
  const d = $("params-drawer");
  for (const inp of d.querySelectorAll("input[name], select[name], textarea[name]")) {
    const v = params[inp.name];
    if (v !== undefined && v !== null) inp.value = String(v);
  }
}

async function toggleDrawer() {
  const d = $("params-drawer");
  const visible = d.style.display === "block";
  d.style.display = visible ? "none" : "block";
  if (!visible && currentSessionId()) {
    const session = await getSession(currentSessionId());
    fillParamsDrawer(session.params || {});
    // model autocomplete from every enabled provider
    const models = await discoverModels().catch(() => ({}));
    const dl = $("models-datalist"); dl.innerHTML = "";
    for (const list of Object.values(models))
      for (const m of list || [])
        dl.appendChild(el("option", "", "")).value = m.id || m.name || m;
  }
}

async function saveParams() {
  if (!currentSessionId()) return;
  const d = $("params-drawer");
  const params = {};
  for (const inp of d.querySelectorAll("input[name], select[name], textarea[name]")) {
    // Empty = "use config default": send an explicit null so the server
    // DELETES the key — a merge-only patch could never un-set a saved
    // value (e.g. orchestrator_enabled back to auto after saving "off").
    if (inp.value === "") { params[inp.name] = null; continue; }
    let v = inp.value;
    if (["temperature", "confidence_cutoff", "confidence_cutoff_hard"].includes(inp.name)) v = parseFloat(v);
    else if (["context_window", "reranker_top_n", "max_tokens",
              "max_iterations", "max_history_turns"].includes(inp.name)) v = parseInt(v, 10);
    else if (v === "true") v = true;
    else if (v === "false") v = false;
    params[inp.name] = v;
  }
  const r = await patchSessionRaw(currentSessionId(), {params});
  $("params-status").textContent = r.ok ? "saved ✓" : `error ${r.status}`;
  setTimeout(() => { $("params-status").textContent = ""; }, 1500);
}

export function wireParamsDrawer() {
  $("params-btn").onclick = toggleDrawer;
  $("params-save").onclick = saveParams;
}
