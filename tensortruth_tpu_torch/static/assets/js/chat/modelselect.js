// Chat-header model quick-switcher (reference frontend
// ModelSelectContent.tsx + ModelStatusDot.tsx): models grouped per
// provider as "provider::model" values, a ● marker on models currently
// resident in the runtime, selection PATCHes the session's params so the
// very next message uses it, and an eject button unloads the resident
// model to free runtime memory.

import {discoverModels} from "../api/providers.js";
import {patchSessionRaw} from "../api/sessions.js";
import {runtimeStatus, runtimeUnload} from "../api/system.js";
import {$, el, toast} from "../lib/dom.js";
import {currentSessionId} from "../stores/session.js";

// "provider_id::model" ⇄ parts (reference encodeModelValue/decodeModelValue).
export function encodeModelValue(providerId, model) { return `${providerId}::${model}`; }
export function decodeModelValue(value) {
  const idx = (value || "").indexOf("::");
  if (idx === -1) return {providerId: "ollama", model: value || ""};
  return {providerId: value.slice(0, idx), model: value.slice(idx + 2)};
}

let discovered = null;   // {provider_id: [model, ...]} cache
let runningSet = new Set();

async function loadCatalog() {
  if (discovered === null) {
    try {
      const raw = await discoverModels();
      discovered = {};
      for (const [pid, list] of Object.entries(raw || {}))
        discovered[pid] = (list || []).map(m => m.id || m.name || String(m));
    } catch (e) { discovered = {}; }
  }
  try {
    const st = await runtimeStatus("ollama");
    runningSet = new Set(st.running || []);
  } catch (e) { runningSet = new Set(); }
  return discovered;
}

export function invalidateModelCatalog() { discovered = null; }

function render(selected) {
  const sel = $("model-select");
  sel.innerHTML = "";
  const dflt = el("option", "", "model: default");
  dflt.value = "";
  sel.appendChild(dflt);
  for (const [pid, models] of Object.entries(discovered || {})) {
    if (!models.length) continue;
    const group = document.createElement("optgroup");
    group.label = pid;
    for (const m of models) {
      const opt = el("option", "", (runningSet.has(m) ? "● " : "") + m);
      opt.value = encodeModelValue(pid, m);
      group.appendChild(opt);
    }
    sel.appendChild(group);
  }
  sel.value = selected || "";
  if (sel.value !== (selected || "")) sel.value = "";  // model vanished from catalog
}

// Called on session open with that session's params.
export async function refreshModelSelect(params) {
  await loadCatalog();
  const p = params || {};
  render(p.model ? encodeModelValue(p.provider_id || "ollama", p.model) : "");
}

async function onPick() {
  if (!currentSessionId()) return;
  const v = $("model-select").value;
  const body = v
    ? {params: {model: decodeModelValue(v).model, provider_id: decodeModelValue(v).providerId}}
    : {params: {model: null, provider_id: null}};
  const r = await patchSessionRaw(currentSessionId(), body);
  if (!r.ok) { toast(`model change failed (${r.status})`, true); return; }
  toast(v ? `next message uses ${decodeModelValue(v).model}` : "model reset to default");
}

async function onEject() {
  const v = $("model-select").value;
  if (!v) return;
  const {model} = decodeModelValue(v);
  try {
    await runtimeUnload("ollama", {model});
    runningSet.delete(model);
    render(v);
    toast(`${model} unloaded`);
  } catch (e) { toast(String(e), true); }
}

export function wireModelSelect() {
  $("model-select").onchange = onPick;
  $("model-eject").onclick = onEject;
}
