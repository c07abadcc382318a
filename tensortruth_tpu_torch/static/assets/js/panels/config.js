// Config panel (reference components/config/ConfigPanel.tsx +
// SessionSettingsPanel.tsx): structured per-section forms with typed
// widgets (range-validated numbers, enum selects, list editors), per-field
// help, per-section reset-to-defaults, and write-through to a raw-JSON
// textarea — the single source of truth for Save, so forms and advanced
// JSON can never diverge: a form change re-serializes the textarea, and
// Save PATCHes whatever the textarea holds. Server-side validation errors
// (400/422 bodies) surface verbatim next to Save.

import {getConfig, getConfigDefaults, patchConfigRaw} from "../api/config.js";
import {$, el} from "../lib/dom.js";

// Typed widget specs per config path (mirrors app/config.py field semantics
// and the reference panel's slider ranges, ConfigPanel.tsx:455-670). Paths
// not listed fall back to type inference from the current value.
const FIELD_SPECS = {
  "llm.default_temperature": {min: 0, max: 2, step: 0.05,
    help: "Sampling temperature for generation (0 = deterministic)."},
  "llm.default_context_window": {min: 512, max: 262144, step: 256, int: true,
    help: "Token window the budgeter partitions (12/18/18/50)."},
  "llm.default_max_tokens": {min: 256, max: 16384, step: 64, int: true,
    help: "Per-response generation cap."},
  "rag.default_device": {options: ["tpu", "cpu"],
    help: "Device the retrieval engine places corpus + models on."},
  "rag.default_balance_strategy": {options: ["top_k_per_index", "global_top_k"],
    help: "Multi-module balance: per-index quotas vs one global pool."},
  "rag.default_top_n": {min: 1, max: 20, int: true,
    help: "Sources kept after reranking."},
  "rag.default_confidence_threshold": {min: 0, max: 1, step: 0.01,
    help: "Soft cutoff: below this the answer is prefixed as low-confidence."},
  "rag.default_confidence_cutoff_hard": {min: 0, max: 1, step: 0.01,
    help: "Hard cutoff: sources below this are dropped entirely."},
  "rag.corpus_dtype": {options: ["bfloat16", "int8", "float32"],
    help: "On-device corpus dtype; int8 halves HBM at ~0 recall cost."},
  "rag.query_batching_max_wait_ms": {min: 0, max: 100, step: 0.5,
    help: "Micro-batcher window: how long a query waits for batch-mates."},
  "rag.query_batching_max_batch": {min: 1, max: 256, int: true,
    help: "Micro-batcher cap per device dispatch."},
  "rag.host_feed_workers": {min: -1, max: 128, int: true,
    help: "Rerank host-feeding workers; -1 = one per core, 0/1 = off."},
  "conversation.max_history_turns": {min: 0, max: 50, int: true,
    help: "Turns kept verbatim before condensation."},
  "conversation.memory_token_limit": {min: 256, max: 65536, int: true,
    help: "Token budget for condensed conversation memory."},
  "agent.max_iterations": {min: 1, max: 30, int: true,
    help: "Orchestrator tool-loop budget (one response = one iteration)."},
  "agent.min_pages_required": {min: 0, max: 20, int: true,
    help: "Web research: minimum fetched pages before answering."},
  "web_search.ddg_max_results": {min: 1, max: 25, int: true,
    help: "Search results requested per query."},
  "web_search.max_pages_to_fetch": {min: 1, max: 15, int: true,
    help: "Pages fetched per search round."},
  "web_search.rerank_title_threshold": {min: 0, max: 1, step: 0.01,
    help: "Title-rerank score below which a result is dropped."},
  "web_search.rerank_content_threshold": {min: 0, max: 1, step: 0.01,
    help: "Content-rerank score below which a page is dropped."},
  "web_search.max_source_context_pct": {min: 0, max: 1, step: 0.01,
    help: "Context share one web source may occupy."},
  "web_search.input_context_pct": {min: 0, max: 1, step: 0.05,
    help: "Context share all web content may occupy."},
  "web_search.citation_style": {options: ["hyperlink", "bracket"],
    help: "Inline citation rendering in synthesized answers."},
};

export async function loadConfigPanel() {
  const cfg = await getConfig();
  $("config-json").value = JSON.stringify(cfg, null, 2);
  renderConfigForms(cfg);
  $("config-status").textContent = "";
}

function setConfigPath(path, value) {
  let cfg;
  try { cfg = JSON.parse($("config-json").value); }
  catch (e) { $("config-status").textContent = "raw JSON invalid — fix it before using forms"; return; }
  let node = cfg;
  for (const k of path.slice(0, -1)) {
    if (typeof node[k] !== "object" || node[k] === null) node[k] = {};
    node = node[k];
  }
  node[path[path.length - 1]] = value;
  $("config-json").value = JSON.stringify(cfg, null, 2);
  $("config-status").textContent = "edited (Save to apply)";
}

function markInvalid(input, msg) {
  input.classList.add("invalid");
  input.title = msg;
  $("config-status").textContent = msg;
}

function clearInvalid(input, spec) {
  input.classList.remove("invalid");
  input.title = (spec && spec.help) || "";
}

function validateNumber(spec, raw) {
  // '' coerces to 0 — a cleared field must not silently write 0
  if (raw === "") return {err: "value required"};
  const n = Number(raw);
  if (Number.isNaN(n)) return {err: "not a number"};
  if (spec) {
    if (spec.int && !Number.isInteger(n)) return {err: "must be an integer"};
    if (spec.min !== undefined && n < spec.min) return {err: `minimum ${spec.min}`};
    if (spec.max !== undefined && n > spec.max) return {err: `maximum ${spec.max}`};
  }
  return {value: n};
}

function numberInput(path, key, val, spec) {
  const input = document.createElement("input");
  input.type = "number";
  input.step = spec && spec.step !== undefined ? String(spec.step)
    : (spec && spec.int ? "1" : "any");
  if (spec && spec.min !== undefined) input.min = spec.min;
  if (spec && spec.max !== undefined) input.max = spec.max;
  input.value = val;
  input.onchange = () => {
    const r = validateNumber(spec, input.value);
    if (r.err) { markInvalid(input, `${key}: ${r.err}`); return; }
    clearInvalid(input, spec);
    setConfigPath(path, r.value);
  };
  return input;
}

function selectInput(path, val, spec) {
  const input = document.createElement("select");
  const opts = spec.options.includes(val) ? spec.options : [val, ...spec.options];
  for (const o of opts) {
    const opt = el("option", "", String(o));
    opt.value = String(o);
    input.appendChild(opt);
  }
  input.value = String(val);
  input.onchange = () => setConfigPath(path, input.value);
  return input;
}

// Scalar lists (chunk_sizes, batch_buckets …) edit as comma-separated
// numbers/strings with validation; lists of objects stay raw-JSON-only.
function listInput(path, key, val) {
  const numeric = val.every(x => typeof x === "number");
  const input = document.createElement("input");
  input.type = "text";
  input.value = val.join(", ");
  input.onchange = () => {
    const parts = input.value.split(",").map(s => s.trim()).filter(Boolean);
    if (numeric) {
      const nums = parts.map(Number);
      if (nums.some(Number.isNaN)) {
        markInvalid(input, `${key}: all entries must be numbers`);
        return;
      }
      clearInvalid(input, null);
      setConfigPath(path, nums);
    } else {
      clearInvalid(input, null);
      setConfigPath(path, parts);
    }
  };
  return input;
}

function renderConfigForms(cfg) {
  const box = $("config-forms"); box.innerHTML = "";
  const isScalar = v => v === null ||
    typeof v === "string" || typeof v === "number" || typeof v === "boolean";
  const isScalarList = v => Array.isArray(v) && v.every(isScalar);
  const fieldRow = (grid, path, key, val) => {
    const spec = FIELD_SPECS[path.join(".")];
    const label = el("div", "k", key);
    if (spec && spec.help) label.title = spec.help;
    grid.appendChild(label);
    let input;
    if (spec && spec.options) {
      input = selectInput(path, val, spec);
    } else if (typeof val === "boolean") {
      input = document.createElement("input");
      input.type = "checkbox"; input.checked = val;
      input.onchange = () => setConfigPath(path, input.checked);
    } else if (typeof val === "number") {
      input = numberInput(path, key, val, spec);
    } else if (Array.isArray(val)) {
      input = listInput(path, key, val);
    } else {
      input = document.createElement("input");
      input.type = "text"; input.value = val === null ? "" : String(val);
      input.placeholder = val === null ? "null" : "";
      input.onchange = () => setConfigPath(path, input.value === "" && val === null ? null : input.value);
    }
    input.className = "cfg-input";
    if (spec && spec.help && !input.title) input.title = spec.help;
    input.dataset.path = path.join(".");
    grid.appendChild(input);
  };
  const section = (title, entries, basePath) => {
    const scalars = entries.filter(([, v]) => isScalar(v) || isScalarList(v));
    if (!scalars.length) return;
    const d = document.createElement("details");
    d.open = basePath.length === 0;
    const s = document.createElement("summary");
    s.textContent = title; s.style.cursor = "pointer"; s.style.margin = "6px 0";
    if (basePath.length) {
      const reset = el("button", "mini", "reset section");
      reset.title = `Restore ${title}.* to shipped defaults (Save to apply)`;
      reset.onclick = async ev => {
        ev.preventDefault();
        const defs = await getConfigDefaults();
        if (defs[title] !== undefined) {
          setConfigPath(basePath, defs[title]);
          renderConfigForms(JSON.parse($("config-json").value));
          $("config-status").textContent = `${title} reset to defaults (Save to apply)`;
        }
      };
      s.appendChild(reset);
    }
    d.appendChild(s);
    const grid = el("div", "kv", "");
    for (const [k, v] of scalars) fieldRow(grid, basePath.concat([k]), k, v);
    d.appendChild(grid);
    box.appendChild(d);
  };
  section("general", Object.entries(cfg), []);
  for (const [sec, val] of Object.entries(cfg)) {
    if (typeof val === "object" && val !== null && !Array.isArray(val)) {
      section(sec, Object.entries(val), [sec]);
    }
  }
}

export function wireConfigPanel() {
  $("config-save").onclick = async () => {
    if (document.querySelector("#config-forms .cfg-input.invalid")) {
      $("config-status").textContent = "fix the highlighted fields first";
      return;
    }
    let patch;
    try { patch = JSON.parse($("config-json").value); }
    catch (e) { $("config-status").textContent = "invalid JSON: " + e; return; }
    const r = await patchConfigRaw(patch);
    if (r.ok) { $("config-status").textContent = "saved ✓"; return; }
    // surface the server's validation message, not just the status code;
    // 422 bodies carry a detail LIST of {loc, msg} (server/schemas.py)
    let detail = "";
    try {
      const body = await r.json();
      if (Array.isArray(body.detail)) {
        detail = body.detail.map(d => `${(d.loc || []).join(".")}: ${d.msg}`).join("; ");
      } else {
        detail = body.error || body.detail || body.message || "";
      }
    } catch (e) { /* non-JSON error body */ }
    $("config-status").textContent = `error ${r.status}${detail ? ": " + detail : ""}`;
  };
  $("config-defaults").onclick = async () => {
    const defs = await getConfigDefaults();
    $("config-json").value = JSON.stringify(defs, null, 2);
    renderConfigForms(defs);
    $("config-status").textContent = "defaults shown (Save to apply)";
  };
}
