// Knowledge-module picker popover (reference frontend
// components/chat/ModuleSelector.tsx + lib/moduleUtils.ts): a composer
// button opens a staged checkbox list grouped by doc type, filtered to the
// session's effective embedding model. Selection is LOCAL until Apply
// PATCHes the session (Cancel reverts); outside clicks refuse to dismiss
// while changes are staged — exactly the reference's onInteractOutside
// guard. In a project session the project's catalog modules render as
// locked rows and only additional modules are toggleable.

import {api} from "../api/client.js";
import {listDocuments} from "../api/documents.js";
import {listModules} from "../api/modules.js";
import {getProject} from "../api/projects.js";
import {getSession, patchSessionRaw} from "../api/sessions.js";
import {$, el, toast} from "../lib/dom.js";
import {currentSessionId} from "../stores/session.js";

// ---- pure helpers (reference lib/moduleUtils.ts, tested on jsrt) ----------

export function shortModelId(model) {
  if (!model) return "";
  const parts = String(model).split("/");
  return parts[parts.length - 1].toLowerCase();
}

export function inferDocType(moduleName) {
  const name = String(moduleName || "").toLowerCase();
  if (name.startsWith("book_")) return {doc_type: "book", sort_order: 1};
  if (name.startsWith("papers_") || name.startsWith("paper_"))
    return {doc_type: "paper", sort_order: 2};
  if (name.startsWith("library_")) return {doc_type: "library_doc", sort_order: 3};
  return {doc_type: "unknown", sort_order: 4};
}

export function displayName(moduleName) {
  const name = String(moduleName || "")
    .replace(/^book_/i, "").replace(/^papers?_/i, "").replace(/^library_/i, "");
  return name.replace(/_/g, " ").replace(/\b\w/g, c => c.toUpperCase());
}

const TYPE_ORDER = ["book", "paper", "library_doc", "unknown"];
const TYPE_LABELS = {
  book: "📚 Books", paper: "📄 Papers",
  library_doc: "📦 Library Docs", unknown: "🗂 Other",
};

// The server derives doc_type from the index dir-name prefix
// (routes/modules.py name.partition("_")[0] → "book"/"papers"/"library");
// normalize those onto the display taxonomy before grouping, falling back
// to the name-based inference for anything else.
export function normalizeDocType(dt, moduleId) {
  const map = {book: "book", paper: "paper", papers: "paper",
               library: "library_doc", library_doc: "library_doc"};
  return map[dt] || inferDocType(moduleId).doc_type;
}

// ---- picker state ----------------------------------------------------------

const state = {
  open: false,
  applied: [],        // the session's saved module list
  local: [],          // staged selection (drives checkboxes)
  modules: [],        // [{id, doc_type, n_chunks, display}] for the model
  locked: [],         // project catalog module names (project sessions)
  docs: [],           // scope documents for the "Session Documents" section
  embeddingModelId: "",
  projectId: null,
};

function hasChanges() {
  const a = new Set(state.applied), l = new Set(state.local);
  if (a.size !== l.size) return true;
  for (const m of l) if (!a.has(m)) return true;
  return false;
}

function totalSelectedCount() {
  return state.locked.length + state.local.length;
}

// Built-module count for the badge tooltip, preloaded at boot (app.js →
// sidebar loadModules) — state.modules only fills when the picker opens,
// so the tooltip must not use it to claim nothing exists.
let catalogCount = null;

export async function preloadModuleCount() {
  try { catalogCount = ((await listModules()).modules || []).length; }
  catch (e) { catalogCount = null; }
  syncBadge();
}

export function moduleBadgeTitle() {
  if (catalogCount === 0 && !state.locked.length)
    return "No modules available. Build indexes with tensor-truth-tpu-build " +
           "or download them in the Startup panel.";
  const n = totalSelectedCount();
  return n > 0 ? `${n} module${n === 1 ? "" : "s"} selected`
               : "Select knowledge modules";
}

function syncBadge() {
  const btn = $("modules-btn");
  const n = totalSelectedCount();
  btn.classList.toggle("active", n > 0);
  btn.title = moduleBadgeTitle();
  let badge = btn.querySelector(".count");
  if (!badge) { badge = el("span", "count", ""); btn.appendChild(badge); }
  badge.textContent = n > 0 ? String(n) : "";
  badge.style.display = n > 0 ? "inline-block" : "none";
}

// ---- data loading ----------------------------------------------------------

async function loadPickerData() {
  const sid = currentSessionId();
  // session + config are independent; modules/project/docs fan out after
  // (the popover opens in ~2 serial round-trips, not 5)
  const [session, cfg] = await Promise.all([
    getSession(sid).catch(() => ({})),
    api("/config").catch(() => ({})),
  ]);
  state.applied = (session.modules || []).slice();
  state.local = state.applied.slice();
  state.projectId = session.project_id || null;

  const model = (session.params && session.params.embedding_model) ||
    (cfg.rag && cfg.rag.default_embedding_model) || "";
  state.embeddingModelId = shortModelId(model);

  const [mods, project, docs] = await Promise.all([
    listModules(model || undefined).catch(() => ({modules: []})),
    state.projectId
      ? getProject(state.projectId).catch(() => null)
      : Promise.resolve(null),
    listDocuments(sid).catch(() => ({documents: []})),
  ]);
  state.modules = (mods.modules || []).map(m => ({
    id: m.id, n_chunks: m.n_chunks,
    doc_type: normalizeDocType(m.doc_type, m.id),
    display: displayName(m.id),
  }));

  // Stale selections (modules deleted or built for another embedding model)
  // are pruned from the STAGED list only — Apply is what persists the prune,
  // mirroring the reference's validSelection effect.
  const available = new Set(state.modules.map(m => m.id));
  state.local = state.local.filter(m => available.has(m));

  state.locked = project ? Object.keys(project.catalog_modules || {}) : [];
  state.docs = (docs && docs.documents) || [];
}

// ---- rendering -------------------------------------------------------------

function moduleRow(m, lockedRow) {
  const row = el("div", "mp-row" + (lockedRow ? " locked" : ""));
  const box = el("span", "mp-check", "");
  const selected = lockedRow || state.local.includes(m.id);
  box.textContent = selected ? "☑" : "☐";
  row.appendChild(box);
  const label = el("span", "mp-name", m.display || m.id);
  row.appendChild(label);
  if (m.n_chunks != null)
    row.appendChild(el("span", "mp-chunks", `${m.n_chunks} chunks`));
  if (lockedRow) row.appendChild(el("span", "mp-lock", "(locked)"));
  else {
    if (selected) row.classList.add("sel");
    row.onclick = () => {
      const i = state.local.indexOf(m.id);
      if (i >= 0) state.local.splice(i, 1); else state.local.push(m.id);
      renderPicker();
    };
  }
  return row;
}

function section(box, label, rows) {
  if (!rows.length) return;
  box.appendChild(el("div", "mp-group", label));
  for (const r of rows) box.appendChild(r);
}

export function renderPicker() {
  const pop = $("module-picker");
  pop.innerHTML = "";
  pop.style.display = state.open ? "block" : "none";
  if (!state.open) return;

  const head = el("div", "mp-head");
  head.appendChild(el("span", "", "Knowledge Modules" +
    (state.embeddingModelId ? ` (${state.embeddingModelId})` : "")));
  if (state.local.length) {
    const clear = el("button", "hbtn", "Clear all");
    clear.onclick = () => { state.local = []; renderPicker(); };
    head.appendChild(clear);
  }
  pop.appendChild(head);

  const body = el("div", "mp-body");
  // 1. scope documents (read-only context — always searched for the scope)
  section(body, state.projectId ? "🗂 Project Knowledge" : "🗂 Session Documents",
    state.docs.map(d => {
      const row = el("div", "mp-row locked");
      row.appendChild(el("span", "mp-check", d.url ? "🔗" : "📄"));
      row.appendChild(el("span", "mp-name", d.filename || d.url || d.doc_id));
      return row;
    }));
  // 2. locked project modules
  const infoById = new Map(state.modules.map(m => [m.id, m]));
  section(body, "🔒 Project Modules", state.locked.map(name =>
    moduleRow(infoById.get(name) ||
      {id: name, display: displayName(name), n_chunks: null}, true)));
  // 3. toggleable modules, grouped by doc type (project context: only the
  //    ones not already locked — the reference's "Additional Modules")
  const lockedSet = new Set(state.locked);
  const toggleable = state.modules.filter(m => !lockedSet.has(m.id));
  if (state.projectId) {
    section(body, "➕ Additional Modules", toggleable.map(m => moduleRow(m)));
  } else {
    const groups = {};
    for (const m of toggleable) (groups[m.doc_type] ||= []).push(m);
    for (const t of TYPE_ORDER) {
      const g = (groups[t] || []).sort((a, b) => a.display.localeCompare(b.display));
      section(body, TYPE_LABELS[t], g.map(m => moduleRow(m)));
    }
  }
  if (!body.children.length)
    body.appendChild(el("div", "dim", "No modules available. Index documents " +
      "with the CLI to create modules."));
  pop.appendChild(body);

  const foot = el("div", "mp-foot");
  const n = state.local.length;
  foot.appendChild(el("span", "dim mp-count",
    totalSelectedCount() === 0 ? "No modules selected (LLM only)"
      : state.projectId
        ? `${state.locked.length} locked + ${n} additional`
        : `${n} module${n === 1 ? "" : "s"} selected`));
  const cancel = el("button", "hbtn", "Cancel");
  cancel.onclick = () => { state.local = state.applied.slice(); closePicker(); };
  foot.appendChild(cancel);
  const apply = el("button", "hbtn primary", "✓ Apply");
  apply.disabled = !hasChanges();
  apply.onclick = applySelection;
  foot.appendChild(apply);
  pop.appendChild(foot);
}

async function applySelection() {
  const r = await patchSessionRaw(currentSessionId(), {modules: state.local});
  if (r.ok) {
    state.applied = state.local.slice();
    toast("modules updated — engine reloads on next message");
    closePicker();
    syncBadge();
  } else {
    toast(`module update failed (${r.status})`, true);
  }
}

function closePicker() { state.open = false; renderPicker(); }

export async function openPicker() {
  if (!currentSessionId()) { toast("open a session first", true); return; }
  await loadPickerData();
  state.open = true;
  renderPicker();
}

// openSession() hands the fresh session here so the badge reflects the
// saved selection without a picker round-trip.
export function syncModulePicker(session) {
  state.applied = (session.modules || []).slice();
  state.local = state.applied.slice();
  state.locked = [];
  state.projectId = session.project_id || null;
  state.open = false;
  renderPicker();
  syncBadge();
  if (session.project_id) {
    getProject(session.project_id).then(p => {
      state.locked = Object.keys(p.catalog_modules || {});
      syncBadge();
    }).catch(() => {});
  }
}

export function pickerState() { return state; }  // executed-test introspection

export function wireModulePicker() {
  $("modules-btn").onclick = ev => {
    ev.stopPropagation();
    if (state.open) {
      if (!hasChanges()) closePicker();
      // staged changes: keep it open, same as the reference popover guard
    } else openPicker();
  };
  document.addEventListener("click", ev => {
    if (!state.open) return;
    if (ev.target.closest && ev.target.closest("#module-picker")) return;
    if (hasChanges()) return;  // refuse outside-dismiss with staged edits
    closePicker();
  });
  syncBadge();
}
