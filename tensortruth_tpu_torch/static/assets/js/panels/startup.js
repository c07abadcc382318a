// Startup panel (reference components/startup/*): first-run status and
// downloadable index bundles with live task progress.

import {availableIndexes, downloadIndexes, startupStatus} from "../api/startup.js";
import {watchTask} from "../api/tasks.js";
import {$, el} from "../lib/dom.js";
import {rowItem} from "../views/manage.js";

export async function loadStartupPanel() {
  const kv = $("startup-kv"); kv.innerHTML = "";
  const put = (k, v) => {
    kv.appendChild(el("div", "k", k));
    kv.appendChild(el("div", "", String(v)));
  };
  const status = await startupStatus();
  put("config", status.config_exists ? "ok" : "missing (created on first run)");
  put("sources", status.sources_exist ? "ok" : "none configured");
  put("indexes", status.indexes_present ? `${status.index_count} built` : "none built");
  put("embedding model", status.default_embedding_model || "—");
  put("modules", (status.modules_configured || []).join(", ") || "none");
  const box = $("startup-indexes"); box.innerHTML = "";
  const avail = await availableIndexes().catch(() => ({indexes: []}));
  if (!(avail.indexes || []).length) box.appendChild(el("div", "dim", "No downloadable bundles (offline)."));
  for (const ix of avail.indexes || []) {
    box.appendChild(rowItem(ix.name || ix.module, ix.embedding_model || "", [
      ["Download", "primary", async ev => {
        const r = await downloadIndexes([ix.module || ix.name]);
        if (r.task_id) watchTask(r.task_id, t => {
          ev.target.textContent = t.status === "completed" ? "✓ built"
            : t.status === "failed" ? "✗ failed" : `${t.stage || t.status}…`;
        });
      }],
    ]));
  }
}
