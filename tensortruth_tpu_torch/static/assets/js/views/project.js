// Project view page (reference frontend components/projects/
// {ProjectViewPage,ProjectConfigPanel,ProjectRightSidebar,
// CatalogModuleItem,CatalogModuleAddPicker}.tsx): a full-screen landing
// view per project — heading with editable name/description, a composer
// that starts a new project session with its first message, a config
// column (system prompt debounced, model, temperature, context window),
// the catalog-module list with per-module status/remove and an add
// picker, the project's documents, and its session list.

import {api} from "../api/client.js";
import {listDocuments} from "../api/documents.js";
import {listModules} from "../api/modules.js";
import {
  addCatalogModule, createProjectSession, getProject, listProjectSessions,
  patchProject, removeCatalogModule,
} from "../api/projects.js";
import {$, el, toast} from "../lib/dom.js";
import {setRoute} from "../lib/router.js";
import {displayName} from "../chat/modulepicker.js";
import {sendWhenOpen} from "../chat/send.js";
import {openSession} from "./sidebar.js";

// Reference ProjectConfigPanel CONTEXT_WINDOW_OPTIONS
export const CONTEXT_WINDOW_OPTIONS =
  [2048, 4096, 8192, 16384, 32768, 65536, 131072];

let current = null;      // open project id, null when the view is hidden
let promptTimer = 0;     // debounced system-prompt save (reference 1000 ms)

export function projectViewId() { return current; }

export function showProjectView(on) {
  $("project-view").style.display = on ? "flex" : "none";
  if (!on) { current = null; setRoute(""); }
}

async function patchParams(projectId, kv) {
  const project = await getProject(projectId);
  await patchProject(projectId, {params: {...(project.params || {}), ...kv}});
}

// ---- config column (ProjectConfigPanel) ------------------------------------

function configColumn(project, models) {
  const box = el("div", "pv-col");
  box.appendChild(el("h4", "", "Configuration"));

  box.appendChild(el("label", "dim", "System prompt"));
  const sp = el("textarea", "pv-prompt");
  sp.rows = 4;
  sp.value = project.system_prompt || "";
  sp.placeholder = "Custom instructions for this project…";
  sp.oninput = () => {
    // debounced save, empty clears (reference handlePromptChange)
    if (promptTimer) clearTimeout(promptTimer);
    promptTimer = setTimeout(async () => {
      promptTimer = 0;
      await patchProject(project.id, {system_prompt: sp.value.trim()});
      toast("project prompt saved");
    }, 1000);
  };
  box.appendChild(sp);

  const params = project.params || {};
  box.appendChild(el("label", "dim", "Model"));
  const ms = el("select", "pv-model-cfg");
  ms.appendChild(el("option", "", "provider default")).value = "";
  for (const m of models) {
    const o = el("option", "", `${m.model} (${m.provider_id})`);
    o.value = m.model;
    ms.appendChild(o);
  }
  ms.value = params.model || "";
  ms.onchange = async () => {
    await patchParams(project.id, {model: ms.value || null});
    toast("project model saved");
  };
  box.appendChild(ms);

  const tRow = el("div", "pv-inline");
  tRow.appendChild(el("label", "dim", "Temperature "));
  const temp = el("input", "pv-temp");
  temp.type = "number"; temp.step = "0.1"; temp.min = "0"; temp.max = "2";
  temp.value = params.temperature != null ? String(params.temperature) : "";
  temp.placeholder = "0.7";
  temp.onchange = async () => {
    const v = parseFloat(temp.value);
    if (!Number.isFinite(v) || v < 0 || v > 2) { toast("temperature 0–2", true); return; }
    await patchParams(project.id, {temperature: v});
    toast("temperature saved");
  };
  tRow.appendChild(temp);
  box.appendChild(tRow);

  box.appendChild(el("label", "dim", "Context window"));
  const cw = el("select", "pv-ctx");
  for (const size of CONTEXT_WINDOW_OPTIONS) {
    const o = el("option", "", String(size));
    o.value = String(size);
    cw.appendChild(o);
  }
  cw.value = String(params.context_window || 8192);
  cw.onchange = async () => {
    await patchParams(project.id, {context_window: parseInt(cw.value, 10)});
    toast("context window saved");
  };
  box.appendChild(cw);
  return box;
}

// ---- knowledge column (CatalogModuleItem + add picker + documents) ---------

function knowledgeColumn(project, builtModules, documents) {
  const box = el("div", "pv-col");
  box.appendChild(el("h4", "", "Knowledge"));

  const list = el("div", "pv-modlist");
  const catalog = project.catalog_modules || {};
  const names = Object.keys(catalog);
  if (!names.length) list.appendChild(el("div", "dim", "No catalog modules attached."));
  for (const name of names) {
    const entry = catalog[name];
    const status = (entry && entry.status) || "indexed";
    const row = el("div", "pv-modrow " + status);
    row.appendChild(el("span", "pv-modstatus",
      status === "indexed" ? "✓" : status === "error" ? "⚠" : "⟳"));
    row.appendChild(el("span", "pv-modname", displayName(name)));
    row.appendChild(el("span", "dim", status));
    const rm = el("button", "hbtn", "✕");
    rm.title = `Detach ${name}`;
    rm.onclick = async () => {
      await removeCatalogModule(project.id, name);
      openProjectView(project.id);  // re-render with server truth
    };
    row.appendChild(rm);
    list.appendChild(row);
  }
  box.appendChild(list);

  // add picker: built modules not yet attached (CatalogModuleAddPicker)
  const attachable = builtModules.filter(m => !catalog[m.id]);
  if (attachable.length) {
    const addRow = el("div", "pv-inline");
    const sel = el("select", "pv-addmod");
    sel.appendChild(el("option", "", "attach a module…")).value = "";
    for (const m of attachable) {
      const o = el("option", "", `${displayName(m.id)} (${m.n_chunks ?? "?"} chunks)`);
      o.value = m.id;
      sel.appendChild(o);
    }
    sel.onchange = async () => {
      if (!sel.value) return;
      try {
        await addCatalogModule(project.id, sel.value);
        openProjectView(project.id);
      } catch (e) { toast(String(e), true); }
    };
    addRow.appendChild(sel);
    box.appendChild(addRow);
  }

  box.appendChild(el("h4", "", "Documents"));
  const docs = el("div", "pv-doclist");
  if (!documents.length) docs.appendChild(el("div", "dim", "No project documents."));
  for (const d of documents) {
    const row = el("div", "pv-docrow");
    row.appendChild(el("span", "", d.url ? "🔗 " : "📄 "));
    row.appendChild(el("span", "pv-docname", d.filename || d.url || d.doc_id));
    if (d.chunks != null) row.appendChild(el("span", "dim", `${d.chunks} chunks`));
    docs.appendChild(row);
  }
  box.appendChild(docs);
  return box;
}

// ---- sessions column -------------------------------------------------------

function sessionsColumn(project, sessions, openSessionFn) {
  const box = el("div", "pv-col");
  box.appendChild(el("h4", "", `Sessions (${sessions.length})`));
  const list = el("div", "pv-sesslist");
  if (!sessions.length) list.appendChild(el("div", "dim", "No sessions yet."));
  for (const s of sessions) {
    const row = el("div", "pv-sessrow");
    row.appendChild(el("span", "pv-sessname", s.title || s.id));
    if (s.message_count != null)
      row.appendChild(el("span", "dim", `${s.message_count} msgs`));
    row.onclick = async () => { showProjectView(false); await openSessionFn(s.id); };
    list.appendChild(row);
  }
  box.appendChild(list);
  return box;
}

// ---- main render -----------------------------------------------------------

export async function openProjectView(projectId) {
  current = projectId;
  setRoute("project/" + projectId);  // deep-linkable (≡ /projects/:id)
  const view = $("project-view");
  view.innerHTML = "";
  view.style.display = "flex";

  let project;
  try { project = await getProject(projectId); }
  catch (e) { view.appendChild(el("div", "dim", "Project not found")); return; }
  if (!project || !project.id) {
    view.appendChild(el("div", "dim", "Project not found"));
    return;
  }
  const [models, built, sessions, documents] = await Promise.all([
    api("/models").then(r => r.models || []).catch(() => []),
    listModules().then(r => r.modules || []).catch(() => []),
    listProjectSessions(projectId).then(r => r.sessions || []).catch(() => []),
    listDocuments({kind: "project", id: projectId})
      .then(r => r.documents || []).catch(() => []),
  ]);
  const close = el("button", "hbtn pv-close", "✕ Close");
  close.onclick = () => showProjectView(false);
  view.appendChild(close);

  const head = el("div", "pv-head");
  const h1 = el("h1", "", project.name);
  h1.title = "Double-click to rename";
  h1.ondblclick = async () => {
    const raw = prompt("Rename project", project.name);
    const name = raw === null ? null : raw.trim();
    if (!name || name === project.name) return;  // trim first: "  " is not a name
    await patchProject(projectId, {name});
    openProjectView(projectId);
  };
  head.appendChild(h1);
  const desc = el("p", "dim pv-desc",
    project.description || "Click to add a description…");
  desc.onclick = async () => {
    const d = prompt("Project description", project.description || "");
    if (d === null) return;
    await patchProject(projectId, {description: d.trim()});
    openProjectView(projectId);
  };
  head.appendChild(desc);
  view.appendChild(head);

  // composer card (reference ProjectViewPage chat input)
  const card = el("div", "pv-card");
  const ta = el("textarea", "pv-input");
  ta.placeholder = "Ask anything about this project…";
  card.appendChild(ta);
  const bar = el("div", "pv-bar");
  const modelSel = el("select", "pv-model");
  modelSel.appendChild(el("option", "", "🤖 project model")).value = "";
  for (const m of models) {
    const o = el("option", "", m.model);
    o.value = m.model;
    modelSel.appendChild(o);
  }
  bar.appendChild(modelSel);
  bar.appendChild(el("span", "dim pv-hint",
    "Enter to send · Shift+Enter for a new line"));
  const send = el("button", "hbtn primary pv-send", "➤ Start chat");
  const submit = async () => {
    const text = ta.value.trim();
    if (!text || send.disabled) return;
    send.disabled = true;
    try {
      const params = modelSel.value ? {model: modelSel.value} : {};
      const s = await createProjectSession(projectId, {params});
      if (!s || !s.id) throw new Error(s && s.error || "session create failed");
      showProjectView(false);
      await openSession(s.id);
      sendWhenOpen(text);
    } catch (e) {
      toast(`could not start the chat: ${e.message || e}`, true);
    } finally { send.disabled = false; }
  };
  send.onclick = submit;
  ta.onkeydown = ev => {
    if (ev.key === "Enter" && !ev.shiftKey) { ev.preventDefault(); submit(); }
  };
  bar.appendChild(send);
  card.appendChild(bar);
  view.appendChild(card);

  const locked = Object.keys(project.catalog_modules || {}).length;
  view.appendChild(el("p", "dim pv-counts",
    "Start a conversation to explore your project knowledge base." +
    (locked ? ` ${locked} module${locked === 1 ? "" : "s"} loaded.` : "") +
    (documents.length
      ? ` ${documents.length} document${documents.length === 1 ? "" : "s"} available.`
      : "")));

  const cols = el("div", "pv-cols");
  cols.appendChild(configColumn(project, models));
  cols.appendChild(knowledgeColumn(project, built, documents));
  cols.appendChild(sessionsColumn(project, sessions, openSession));
  view.appendChild(cols);
}
