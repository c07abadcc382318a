// Sidebar + chat-view session lifecycle: project-grouped session list
// with filter, knowledge-module picker (live per-session), document
// upload with progress, session open/rename/export (reference
// components/sessions/{SessionList,ProjectSessionList,SessionItem}.tsx +
// useSessionStore).

import {uploadDocumentXHR} from "../api/documents.js";
import {
  createProject, createProjectSession, deleteProject, listProjects,
} from "../api/projects.js";
import {
  createSession, deleteSession, getSession, listSessions as listSessionsApi,
  imageUrl, patchSession,
} from "../api/sessions.js";
import {onContextMenu} from "../lib/contextmenu.js";
import {$, el} from "../lib/dom.js";
import {setRoute} from "../lib/router.js";
import {renderMarkdown} from "../lib/markdown.js";
import {sessionStore, currentSessionId} from "../stores/session.js";
import {
  addMessage, decorateCodeBlocks, openLightbox, renderMetrics,
  renderSources, renderStats, renderThinking, renderToolSteps,
  renderWelcome,
} from "../chat/messages.js";
import {refreshModelSelect} from "../chat/modelselect.js";
import {preloadModuleCount, syncModulePicker} from "../chat/modulepicker.js";
import {fillParamsDrawer} from "../chat/params.js";
import {syncThinkingSelect} from "../chat/composer.js";
import {closeWS, connectWS} from "../chat/ws.js";
import {openProjectView} from "./project.js";

let projects = [];            // [{id, name, ...}] for grouped rendering
const collapsed = new Set(    // persisted collapsed project groups
  JSON.parse(localStorage.getItem("tt-collapsed") || "[]"));

function persistCollapsed() {
  try { localStorage.setItem("tt-collapsed", JSON.stringify([...collapsed])); }
  catch (e) {}
}

export async function loadSessions() {
  const data = await listSessionsApi();
  sessionStore.set({sessions: data.sessions});
}

export async function loadProjects() {
  const data = await listProjects();
  projects = data.projects;
  // the welcome card's project quick-access chips read this field
  sessionStore.set({projects: data.projects});
}

// Module catalog preload: feeds the composer badge tooltip ("No modules
// available" only when the catalog is genuinely empty); the picker itself
// refetches filtered by the session's embedding model on open.
export async function loadModules() {
  await preloadModuleCount();
}

// Long-session hygiene (reference virtualizes with react-virtuoso): opening
// a session paints only the most recent HISTORY_WINDOW messages — first
// paint stays O(window) however long the session is — with a "show earlier"
// expander that renders the full history on demand. Offscreen rows are
// additionally skipped at layout/paint time via `content-visibility: auto`
// on `.msg` (app.css), the no-framework equivalent of list virtualization.
const HISTORY_WINDOW = 80;

function renderHistoryMessage(id, m, mi) {
  const wrap = addMessage(m.role, m.role === "assistant" ? "" : m.content,
                          {index: mi, timestamp: m.timestamp,
                           onDelete: () => openSession(id)});
  if (m.role === "assistant") {
    const body = wrap.querySelector(".body");
    body.classList.add("md");
    body.innerHTML = renderMarkdown(m.content || "");
    decorateCodeBlocks(body);
    if (m.thinking) renderThinking(wrap, m.thinking);
  }
  for (const imgId of m.images || []) {
    const img = document.createElement("img");
    img.src = imageUrl(id, imgId);
    img.style.cssText =
      "max-width:240px; border-radius:8px; margin-top:6px; display:block; cursor:zoom-in;";
    img.onclick = () => openLightbox(img.src);
    wrap.appendChild(img);
  }
  renderSources(wrap, m.sources);
  renderToolSteps(wrap, m.tool_steps);
  renderMetrics(wrap, m.metrics, m.confidence);
  renderStats(wrap, m.stats);  // persisted generation stats survive reload
  return wrap;
}

export async function openSession(id, opts) {
  closeWS();
  setRoute("session/" + id);  // deep-linkable (≡ reference /chat/:id)
  $("messages").innerHTML = "";
  const session = await getSession(id);
  sessionStore.set({current: id, title: session.title || id});
  const msgs = session.messages;
  const start = (opts && opts.full) ? 0 : Math.max(0, msgs.length - HISTORY_WINDOW);
  if (start > 0) {
    const more = el("button", "hbtn expand-history",
                    `⌃ show ${start} earlier message${start === 1 ? "" : "s"}`);
    more.onclick = () => openSession(id, {full: true});
    $("messages").appendChild(more);
  }
  for (let mi = start; mi < msgs.length; mi++)
    renderHistoryMessage(id, msgs[mi], mi);
  if (!msgs.length) renderWelcome();
  fillParamsDrawer(session.params || {});
  syncThinkingSelect(session.params || {});
  refreshModelSelect(session.params || {});
  syncModulePicker(session);  // composer badge reflects the saved modules
  connectWS();
  loadSessions();
}

// -- document upload with progress -------------------------------------------
export function uploadDocument(file) {
  if (!currentSessionId()) return;
  const bar = $("upload-progress");
  bar.style.display = "block";
  bar.firstElementChild.style.width = "0%";
  $("statusline").textContent = `uploading ${file.name}…`;
  uploadDocumentXHR(currentSessionId(), file, {
    onProgress: pct => { bar.firstElementChild.style.width = `${pct}%`; },
    onIndexing: () => { $("statusline").textContent = `indexing ${file.name}…`; },
    onDone: (status, data) => {
      bar.style.display = "none";
      $("statusline").textContent = status < 300
        ? `indexed ${file.name} (${data.chunks} chunks)`
        : `upload failed: ${data.error || data.detail || status}`;
    },
    onError: () => {
      bar.style.display = "none";
      $("statusline").textContent = "upload failed";
    },
  });
}

async function exportSession(id) {
  id = id || currentSessionId();
  if (!id) return;
  const session = await getSession(id);
  const lines = [`# ${session.title || session.id}`, ""];
  for (const m of session.messages) {
    lines.push(`## ${m.role}${m.timestamp ? ` — ${m.timestamp}` : ""}`, "", m.content || "", "");
    for (const s of m.sources || [])
      lines.push(`> [${(s.score ?? 0).toFixed?.(2) ?? "—"}] ${s.title || s.id || ""} ${s.url || ""}`);
    if ((m.sources || []).length) lines.push("");
  }
  const blob = new Blob([lines.join("\n")], {type: "text/markdown"});
  const a = document.createElement("a");
  a.href = URL.createObjectURL(blob);
  a.download = `${(session.title || session.id).replace(/[^\w-]+/g, "_")}.md`;
  a.click();
  URL.revokeObjectURL(a.href);
}

// -- grouped session rendering ------------------------------------------------

// In-place rename (reference SessionItem.tsx inline editing state): the
// title span swaps for an input; Enter/blur commit, Escape reverts.
function startInlineRename(row, s) {
  const span = row.firstElementChild;
  const input = document.createElement("input");
  input.className = "rename-input";
  input.value = s.title || s.id;
  row.replaceChild(input, span);
  input.focus();
  let done = false;
  const commit = async () => {
    if (done) return;
    done = true;
    const name = input.value.trim();
    if (name && name !== (s.title || s.id)) {
      await patchSession(s.id, {title: name});
      if (sessionStore.get().current === s.id) sessionStore.set({title: name});
    }
    loadSessions();
  };
  input.onkeydown = ev => {
    if (ev.key === "Enter") commit();
    else if (ev.key === "Escape") { done = true; loadSessions(); }
  };
  input.onblur = commit;
  input.onclick = ev => ev.stopPropagation();
}

async function removeSession(s, st) {
  await deleteSession(s.id);
  if (st.current === s.id) {
    sessionStore.set({current: null, title: ""});
    $("messages").innerHTML = "";
  }
  loadSessions();
}

function sessionRow(s, st) {
  const d = el("div", "session" + (st.current === s.id ? " active" : ""));
  d.appendChild(el("span", "", s.title || s.id));
  const x = el("span", "del", "×");
  x.title = "Delete session";
  x.onclick = ev => { ev.stopPropagation(); removeSession(s, st); };
  d.appendChild(x);
  d.onclick = () => openSession(s.id);
  // Right-click row actions (reference SessionItem.tsx ContextMenu):
  // rename inline, duplicate config into a fresh session, export, delete.
  onContextMenu(d, () => [
    {label: "✎ Rename", onPick: () => startInlineRename(d, s)},
    {label: "⧉ Duplicate", onPick: async () => {
      const full = await getSession(s.id);
      const copy = await createSession({
        title: `${full.title || full.id} (copy)`,
        modules: full.modules || [], params: full.params || {},
      });
      await openSession(copy.id);
    }},
    {label: "⇩ Export markdown", onPick: () => exportSession(s.id)},
    "---",
    {label: "✕ Delete", danger: true, onPick: () => removeSession(s, st)},
  ]);
  return d;
}

function renderSessionLists(st) {
  const needle = ($("session-filter").value || "").toLowerCase();
  const match = s => !needle || (s.title || s.id).toLowerCase().includes(needle);

  // flat list = sessions that belong to no project
  const box = $("sessions"); box.innerHTML = "";
  for (const s of st.sessions)
    if (!s.project_id && match(s)) box.appendChild(sessionRow(s, st));

  // project groups (reference ProjectSessionList.tsx): header row with
  // collapse caret, new-session and delete actions, nested session rows
  const pbox = $("projects"); pbox.innerHTML = "";
  for (const pr of projects) {
    const head = el("div", "project-head");
    const caret = el("span", "caret", collapsed.has(pr.id) ? "▸" : "▾");
    head.appendChild(caret);
    const nameEl = el("span", "pname", pr.name);
    nameEl.title = "Open project page";
    nameEl.onclick = ev => {  // reference: project rows navigate to the view
      ev.stopPropagation();
      openProjectView(pr.id);
    };
    head.appendChild(nameEl);
    const add = el("span", "padd", "+");
    add.title = "New session in this project";
    add.onclick = async ev => {
      ev.stopPropagation();
      const s = await createProjectSession(pr.id);
      await openSession(s.id);
    };
    head.appendChild(add);
    const x = el("span", "del", "×");
    x.title = "Delete project";
    x.onclick = async ev => {
      ev.stopPropagation();
      if (!confirm(`Delete project "${pr.name}"? Its sessions stay.`)) return;
      await deleteProject(pr.id);
      loadProjects();
    };
    head.appendChild(x);
    head.onclick = () => {
      if (collapsed.has(pr.id)) collapsed.delete(pr.id); else collapsed.add(pr.id);
      persistCollapsed();
      sessionStore.set({});
    };
    pbox.appendChild(head);
    if (collapsed.has(pr.id)) continue;
    const kids = st.sessions.filter(s => s.project_id === pr.id && match(s));
    for (const s of kids) {
      const row = sessionRow(s, st);
      row.classList.add("nested");
      pbox.appendChild(row);
    }
    if (!kids.length) pbox.appendChild(el("div", "dim nested", "no sessions"));
  }
}

export function wireSidebar() {
  sessionStore.subscribe(st => {
    renderSessionLists(st);
    $("chat-title").textContent = st.title || (st.current ? st.current : "—");
  });

  $("new-session").onclick = async () => {
    // modules are picked per-session afterwards via the composer's module
    // picker (reference: ModuleSelector lives in ChatInput, not the sidebar)
    const s = await createSession({});
    await openSession(s.id);
  };
  $("new-project").onclick = async () => {
    const name = prompt("Project name?");
    if (!name) return;
    await createProject({name});
    loadProjects();
  };
  $("upload-btn").onclick = () => $("file-input").click();
  $("file-input").onchange = ev => {
    if (ev.target.files[0]) uploadDocument(ev.target.files[0]);
    ev.target.value = "";
  };
  $("session-filter").addEventListener("input", () => sessionStore.set({}));
  $("export-btn").onclick = () => exportSession();
  $("chat-title").ondblclick = async () => {
    if (!currentSessionId()) return;
    const name = prompt("Rename session", sessionStore.get().title);
    if (!name) return;
    await patchSession(currentSessionId(), {title: name});
    sessionStore.set({title: name});
    loadSessions();
  };
}
