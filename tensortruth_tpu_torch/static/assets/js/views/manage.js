// Management console shell (reference components/config/* navigation):
// chat↔manage view switch, tab strip, one loader per panel, and the shared
// row-item builder every panel renders with.

import {$, el} from "../lib/dom.js";
import {setRoute} from "../lib/router.js";
import {uiStore} from "../stores/ui.js";
import {loadConfigPanel} from "../panels/config.js";
import {loadDocumentsPanel} from "../panels/documents.js";
import {loadExtensionsPanel} from "../panels/extensions.js";
import {loadMcpPanel} from "../panels/mcp.js";
import {loadModulesPanel} from "../panels/modules.js";
import {loadProjectsPanel} from "../panels/projects.js";
import {loadProvidersPanel} from "../panels/providers.js";
import {loadStartupPanel} from "../panels/startup.js";
import {loadSystemPanel} from "../panels/system.js";
import {loadToolsPanel} from "../panels/tools.js";

const PANEL_LOADERS = {
  providers: loadProvidersPanel, documents: loadDocumentsPanel,
  modules: loadModulesPanel, projects: loadProjectsPanel,
  config: loadConfigPanel, system: loadSystemPanel,
  extensions: loadExtensionsPanel, mcp: loadMcpPanel,
  tools: loadToolsPanel, startup: loadStartupPanel,
};

export function showManage(show, panel) {
  uiStore.set({view: show ? "manage" : "chat"});
  $("chat-view").style.display = show ? "none" : "flex";
  $("manage").style.display = show ? "flex" : "none";
  if (show) switchPanel(panel || uiStore.get().tab || "providers");
  else setRoute("");  // back to the chat deep link
}

export function switchPanel(name) {
  uiStore.set({tab: name});
  setRoute("manage/" + name);  // deep-linkable (≡ reference router paths)
  for (const t of document.querySelectorAll("#manage-tabs .tab[data-panel]"))
    t.classList.toggle("active", t.dataset.panel === name);
  for (const p of document.querySelectorAll(".panel"))
    p.classList.toggle("active", p.id === "panel-" + name);
  (PANEL_LOADERS[name] || (() => {}))();
}

export function rowItem(main, sub, buttons) {
  const d = el("div", "row-item");
  const g = el("div", "grow", main);
  if (sub) { g.appendChild(el("div", "dim", sub)); }
  d.appendChild(g);
  for (const [label, cls, fn] of buttons || []) {
    const b = el("button", cls, label);
    b.onclick = fn;
    d.appendChild(b);
  }
  return d;
}

export function wireManage() {
  $("manage-btn").onclick = () => showManage(true);
  $("manage-close").onclick = () => showManage(false);
  for (const t of document.querySelectorAll("#manage-tabs .tab[data-panel]"))
    t.onclick = () => switchPanel(t.dataset.panel);
}
