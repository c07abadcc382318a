// Projects panel (reference components/projects/*): CRUD, catalog-module
// attach via per-module checkboxes, jump into a fresh project session.

import {listModules} from "../api/modules.js";
import {
  addCatalogModule, createProject, createProjectSession, deleteProject,
  listProjects, patchIndexingConfig, patchProject, removeCatalogModule,
} from "../api/projects.js";
import {$, el} from "../lib/dom.js";
import {openSession, loadProjects} from "../views/sidebar.js";
import {rowItem, showManage} from "../views/manage.js";

export async function loadProjectsPanel() {
  const [projects, mods] = await Promise.all([listProjects(), listModules()]);
  const box = $("projects-list"); box.innerHTML = "";
  if (!projects.projects.length) box.appendChild(el("div", "dim", "No projects yet."));
  for (const pr of projects.projects) {
    const sysPrompt = (pr.config || {}).system_prompt || pr.system_prompt || "";
    const row = rowItem(pr.name,
      `modules: ${(pr.modules || []).join(", ") || "none"}` +
      (sysPrompt ? ` · prompt: ${sysPrompt.slice(0, 60)}` : ""), [
      ["+ Session", "primary", async () => {
        const s = await createProjectSession(pr.id);
        showManage(false);
        await openSession(s.id);
      }],
      ["Rename", "", async () => {
        // reference ProjectConfigPanel name editing
        const name = prompt(`Rename project "${pr.name}" to:`, pr.name);
        if (name === null || !name.trim() || name === pr.name) return;
        await patchProject(pr.id, {name: name.trim()});
        loadProjectsPanel(); loadProjects();
      }],
      ["Prompt", "", async () => {
        // reference ProjectConfigPanel system-prompt editing; empty clears
        const sp = prompt(
          `System prompt for "${pr.name}" (empty clears):`, sysPrompt);
        if (sp === null) return;
        await patchProject(pr.id, {system_prompt: sp.trim() || null});
        loadProjectsPanel();
      }],
      ["Delete", "danger", async () => {
        if (!confirm(`Delete project ${pr.name} and its scope index?`)) return;
        await deleteProject(pr.id);
        loadProjectsPanel(); loadProjects();
      }],
    ]);
    box.appendChild(row);
    // catalog-module attach/detach via the dedicated endpoints (reference
    // documents.py:866-959); checked = attached in pr.catalog_modules OR a
    // plain project module.
    const attach = el("div", "row-item");
    attach.style.flexWrap = "wrap";
    attach.appendChild(el("span", "dim", "catalog:"));
    const catalog = pr.catalog_modules || {};
    for (const m of mods.modules) {
      const name = m.id || m.module;
      const lbl = el("label", "dim");
      const cb = document.createElement("input");
      cb.type = "checkbox";
      cb.checked = !!catalog[name] || (pr.modules || []).includes(name)
        || (pr.modules || []).includes(m.module);
      cb.onchange = async () => {
        try {
          if (cb.checked) await addCatalogModule(pr.id, name);
          else await removeCatalogModule(pr.id, name);
        } catch (e) { /* 409 double-attach etc — reload shows truth */ }
        loadProjectsPanel();
      };
      lbl.appendChild(cb);
      lbl.appendChild(document.createTextNode(" " + m.module));
      lbl.style.marginRight = "10px";
      attach.appendChild(lbl);
    }
    if (!mods.modules.length) attach.appendChild(el("span", "dim", "no built modules"));
    box.appendChild(attach);
    // indexing config: chunk sizes editor (reference indexing-config PATCH)
    const idxRow = el("div", "row-item");
    idxRow.appendChild(el("span", "dim", "chunk sizes:"));
    const sizes = document.createElement("input");
    sizes.type = "text";
    sizes.placeholder = "2048,512,256";
    const indexing = (pr.config || {}).indexing || {};
    sizes.value = (indexing.chunk_sizes || []).join(",");
    sizes.style.width = "140px";
    sizes.onchange = async () => {
      const parsed = sizes.value.split(",").map(s => parseInt(s.trim(), 10))
        .filter(n => Number.isFinite(n) && n > 0);
      if (parsed.length) await patchIndexingConfig(pr.id, {chunk_sizes: parsed});
      loadProjectsPanel();
    };
    idxRow.appendChild(sizes);
    box.appendChild(idxRow);
  }
}

export function wireProjectsPanel() {
  $("project-form").onsubmit = async ev => {
    ev.preventDefault();
    const f = new FormData(ev.target);
    await createProject({
      name: f.get("name"), system_prompt: f.get("system_prompt") || undefined,
    });
    ev.target.reset();
    loadProjectsPanel(); loadProjects();
  };
}
