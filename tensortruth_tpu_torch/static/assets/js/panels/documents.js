// Scope-aware documents panel (reference components/documents/
// DocumentPanel.tsx + DocumentList.tsx + DocumentUploader.tsx: one panel
// serves BOTH scope types): per-document rows with chunk badges,
// confirm-and-busy delete with error surfacing, a corpus summary line,
// multi-file upload queue with per-file progress, URL ingestion (with a
// pre-flight probe of the content type/handler), pasted-text ingestion,
// arXiv-id ingestion, full reindex with progress feedback — against the
// current session OR any project, selected in the scope dropdown.

import {arxivLookup} from "../api/arxiv.js";
import {
  addTextDocument, addUrlDocument, deleteDocument, fileUrlInfo, listDocuments,
  reindexDocuments, uploadDocumentXHR,
} from "../api/documents.js";
import {getIndexingConfig, listProjects, patchIndexingConfig} from "../api/projects.js";
import {$, el, toast} from "../lib/dom.js";
import {currentSessionId} from "../stores/session.js";
import {rowItem} from "../views/manage.js";

// Selected scope: {kind: "session"|"project", id} or null when nothing is
// selectable (no open session and no projects).
let scope = null;

function describeScope() {
  if (!scope) return "Open a session or create a project first.";
  return scope.kind === "project"
    ? `Documents indexed into project ${scope.label || scope.id}`
    : `Documents indexed into session ${scope.id}`;
}

async function refreshScopeSelect() {
  const sel = $("doc-scope");
  const prev = sel.value;
  sel.innerHTML = "";
  const sid = currentSessionId();
  if (sid) {
    const opt = el("option", "", `Session ${sid}`);
    opt.value = `session:${sid}`;
    sel.appendChild(opt);
  }
  const projects = (await listProjects().catch(() => ({projects: []}))).projects || [];
  for (const pr of projects) {
    const opt = el("option", "", `Project: ${pr.name}`);
    opt.value = `project:${pr.id}`;
    opt.dataset.label = pr.name;
    sel.appendChild(opt);
  }
  if (!sel.options.length) { scope = null; return; }
  // keep the previous pick when still listed, else default to the session
  const values = [...sel.options].map(o => o.value);
  sel.value = values.includes(prev) ? prev : values[0];
  applyScopeSelect();
}

function applyScopeSelect() {
  const v = $("doc-scope").value;
  if (!v) { scope = null; return; }
  const [kind, ...rest] = v.split(":");
  const id = rest.join(":");
  const opt = [...$("doc-scope").options].find(o => o.value === v);
  scope = {kind, id, label: opt && opt.dataset.label};
}

function docRow(doc) {
  const row = rowItem(doc.filename || doc.id, doc.id, [
    ["Delete", "danger", async ev => {
      if (!confirm(`Remove ${doc.filename || doc.id} from this index?`)) return;
      ev.target.textContent = "…";
      ev.target.disabled = true;
      try {
        const r = await deleteDocument(scope, doc.id);
        if (r && r.error) throw new Error(r.error);
        toast(`removed ${doc.filename || doc.id} (${r.chunks_removed ?? "?"} chunks)`);
      } catch (e) {
        toast(`delete failed: ${e.message || e}`, true);
        ev.target.textContent = "Delete";
        ev.target.disabled = false;
        return;
      }
      reloadList();
    }],
  ]);
  const chunks = el("span", "badge" + ((doc.chunks ?? 0) > 0 ? " on" : " err"),
    (doc.chunks ?? 0) > 0 ? `${doc.chunks} chunks` : "0 chunks");
  if ((doc.chunks ?? 0) === 0) chunks.title = "No leaf chunks indexed — reindex or remove";
  row.insertBefore(chunks, row.children[1]);
  return row;
}

function renderList(docs) {
  const box = $("documents-list"); box.innerHTML = "";
  const summary = $("documents-summary");
  if (!docs.length) {
    box.appendChild(el("div", "dim", "No documents yet."));
    if (summary) summary.textContent = "";
    return;
  }
  if (summary) {
    const total = docs.reduce((a, d) => a + (d.chunks || 0), 0);
    summary.textContent = `${docs.length} document${docs.length === 1 ? "" : "s"} · ${total} chunks indexed`;
  }
  for (const doc of docs) box.appendChild(docRow(doc));
}

// Per-project chunking settings (reference components/documents/
// IndexingSettings.tsx): preset (papers / books) or custom three-level
// sizes, conversion method, explicit Save — a real change drops the scope
// index so the next build is a full rebuild (server routes/projects.py).
export const CHUNK_PRESETS = {
  papers: [2048, 512, 256],
  books: [3072, 768, 384],
};

export function presetFromSizes(sizes) {
  for (const [key, preset] of Object.entries(CHUNK_PRESETS))
    if (preset.length === sizes.length && preset.every((v, i) => v === sizes[i]))
      return key;
  return "custom";
}

async function renderIndexingSettings() {
  const box = $("doc-indexing");
  box.innerHTML = "";
  if (!scope || scope.kind !== "project") { box.style.display = "none"; return; }
  box.style.display = "block";
  // Never render the editor over defaults when the REAL config could not
  // be read: saving defaults over a customized config silently drops the
  // project's index (server treats any change as a rebuild trigger).
  let cfg;
  try { cfg = await getIndexingConfig(scope.id); } catch (e) { cfg = null; }
  if (!cfg || typeof cfg !== "object") {
    box.appendChild(el("h4", "", "Indexing settings"));
    box.appendChild(el("div", "dim", "Could not load this project's indexing config."));
    const retry = el("button", "hbtn", "Retry");
    retry.onclick = () => renderIndexingSettings();
    box.appendChild(retry);
    return;
  }
  const sizes = (cfg.chunk_sizes || [2048, 512, 256]).slice();
  let preset = presetFromSizes(sizes);
  let method = cfg.conversion_method || "marker";

  box.appendChild(el("h4", "", "Indexing settings"));
  box.appendChild(el("div", "dim",
    "Changing chunk sizes or conversion drops this project's index; the " +
    "next upload or reindex rebuilds it."));
  const form = el("div", "mini-form");
  const presetSel = el("select", "idx-preset");
  for (const [val, label] of [["papers", "Papers (2048 / 512 / 256)"],
                              ["books", "Books (3072 / 768 / 384)"],
                              ["custom", "Custom"]]) {
    const o = el("option", "", label); o.value = val; presetSel.appendChild(o);
  }
  presetSel.value = preset;
  form.appendChild(presetSel);
  const sizeInputs = sizes.map(v => {
    const inp = el("input", "idx-size");
    inp.type = "number"; inp.min = "64"; inp.step = "64";
    inp.value = String(v);
    inp.style.width = "70px";
    inp.disabled = preset !== "custom";
    inp.oninput = () => { presetSel.value = "custom"; };
    form.appendChild(inp);
    return inp;
  });
  presetSel.onchange = () => {
    preset = presetSel.value;
    const chosen = CHUNK_PRESETS[preset];
    sizeInputs.forEach((inp, i) => {
      inp.disabled = preset !== "custom";
      if (chosen) inp.value = String(chosen[i]);
    });
  };
  const methodSel = el("select", "idx-method");
  for (const m of ["marker", "direct"]) {
    const o = el("option", "", `conversion: ${m}`); o.value = m;
    methodSel.appendChild(o);
  }
  methodSel.value = method;
  form.appendChild(methodSel);
  const save = el("button", "primary idx-save", "Save");
  save.onclick = async () => {
    const chosen = CHUNK_PRESETS[presetSel.value] ||
      sizeInputs.map(i => parseInt(i.value, 10));
    if (chosen.some(v => !Number.isFinite(v) || v < 64)) {
      toast("chunk sizes must be ≥64", true);
      return;
    }
    try {
      await patchIndexingConfig(scope.id, {
        chunk_sizes: chosen, conversion_method: methodSel.value,
      });
      toast("indexing settings saved");
    } catch (e) { toast(`save failed: ${e}`, true); }
  };
  form.appendChild(save);
  box.appendChild(form);
}

export async function loadDocumentsPanel() {
  await refreshScopeSelect();
  $("documents-session-label").textContent = describeScope();
  $("documents-list").innerHTML = "";
  renderIndexingSettings();
  if (!scope) return;
  const data = await listDocuments(scope);
  renderList(data.documents || []);
}

// List-only refresh: the scope select keeps the user's pick (a full
// loadDocumentsPanel re-resolves the dropdown, which is only needed when
// sessions/projects changed).
async function reloadList() {
  $("documents-session-label").textContent = describeScope();
  $("documents-list").innerHTML = "";
  if (!scope) return;
  const data = await listDocuments(scope);
  renderList(data.documents || []);
}

// Sequential multi-file upload queue (reference DocumentUploader): one
// XHR at a time so per-file progress is meaningful on the statusline, and
// one failure doesn't abort the remaining files.
function uploadQueue(files) {
  const queue = [...files];
  let done = 0, failed = 0;
  const next = () => {
    const file = queue.shift();
    if (!file) {
      $("statusline").textContent = "";
      toast(`uploaded ${done}/${done + failed} file${done + failed === 1 ? "" : "s"}`,
        failed > 0);
      reloadList();
      return;
    }
    const pos = `${done + failed + 1}/${done + failed + queue.length + 1}`;
    $("statusline").textContent = `uploading ${file.name} (${pos})…`;
    uploadDocumentXHR(scope, file, {
      onProgress: pct => { $("statusline").textContent = `uploading ${file.name} (${pos}) ${pct}%`; },
      onIndexing: () => { $("statusline").textContent = `indexing ${file.name} (${pos})…`; },
      onDone: (status, data) => {
        if (status < 300) { done++; toast(`indexed ${file.name} (${data.chunks} chunks)`); }
        else { failed++; toast(`${file.name}: ${data.error || data.detail || status}`, true); }
        next();
      },
      onError: () => { failed++; toast(`${file.name}: upload failed`, true); next(); },
    });
  };
  next();
}

export function wireDocumentsPanel() {
  $("doc-scope").onchange = () => {
    applyScopeSelect();
    reloadList();
    renderIndexingSettings();  // project scopes expose chunking settings
  };
  $("doc-upload-btn").onclick = () => $("doc-file-input").click();
  $("doc-file-input").onchange = ev => {
    const files = [...ev.target.files];
    ev.target.value = "";
    if (!files.length || !scope) return;
    uploadQueue(files);
  };
  $("doc-url-form").onsubmit = async ev => {
    ev.preventDefault();
    if (!scope) return;
    const f = new FormData(ev.target);
    const url = f.get("url");
    // pre-flight probe: surface the handler + content type before the
    // (potentially slow) fetch-and-index round-trip
    const info = await fileUrlInfo(url).catch(() => null);
    if (info && info.handler)
      toast(`ingesting via ${info.handler}`);
    const r = await addUrlDocument(scope, url).catch(e => ({error: String(e)}));
    if (r && r.error) { toast(`URL ingest failed: ${r.error}`, true); return; }
    ev.target.reset();
    reloadList();
  };
  $("doc-text-form").onsubmit = async ev => {
    ev.preventDefault();
    if (!scope) return;
    const f = new FormData(ev.target);
    const r = await addTextDocument(scope, f.get("filename") || "pasted.md", f.get("text"))
      .catch(e => ({error: String(e)}));
    if (r && r.error) { toast(`ingest failed: ${r.error}`, true); return; }
    ev.target.reset();
    reloadList();
  };
  $("doc-arxiv-form").onsubmit = async ev => {
    ev.preventDefault();
    if (!scope) return;
    const f = new FormData(ev.target);
    const arxivId = String(f.get("arxiv_id") || "").trim();
    if (!arxivId) return;
    $("statusline").textContent = `fetching arXiv ${arxivId}…`;
    const r = await arxivLookup(arxivId).catch(e => ({error: String(e)}));
    if (r.error) { toast(r.error, true); $("statusline").textContent = ""; return; }
    await addTextDocument(scope,
      `arxiv_${arxivId.replace(/[^\w.]+/g, "_")}.md`, r.markdown);
    $("statusline").textContent = "";
    toast(`indexed arXiv ${arxivId}: ${r.title || ""}`);
    ev.target.reset();
    reloadList();
  };
  $("docs-reindex").onclick = async ev => {
    if (!scope) return;
    ev.target.textContent = "Reindexing…";
    ev.target.disabled = true;
    try {
      const r = await reindexDocuments(scope);
      ev.target.textContent = `Reindexed ${r.documents ?? ""} ✓`;
    } catch (e) {
      toast(`reindex failed: ${e}`, true);
      ev.target.textContent = "Reindex all";
    }
    ev.target.disabled = false;
    setTimeout(() => { ev.target.textContent = "Reindex all"; }, 2000);
    reloadList();
  };
}
