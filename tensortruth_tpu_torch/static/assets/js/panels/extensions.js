// Extensions panel (reference components/config/ExtensionsSection.tsx):
// installed YAML extensions with confirm+toast uninstall, remote catalog
// with installed-state marking, bulk install of everything missing, and
// hot reload (which also invalidates the slash-command autocomplete cache).

import {
  extensionLibrary, installExtension, listExtensions, reloadExtensions,
  uninstallExtension,
} from "../api/extensions.js";
import {invalidateCommandCatalog} from "../chat/composer.js";
import {$, el, toast} from "../lib/dom.js";
import {rowItem} from "../views/manage.js";

export async function loadExtensionsPanel() {
  const box = $("extensions-list");
  const cat = $("extension-catalog");
  box.innerHTML = "";
  box.appendChild(el("div", "dim", "loading…"));
  const [inst, lib] = await Promise.all([
    listExtensions(), extensionLibrary().catch(() => ({catalog: []})),
  ]);
  box.innerHTML = "";
  const installed = inst.extensions || [];
  const installedNames = new Set(installed.map(e => e.name || e.filename));
  if (!installed.length) box.appendChild(el("div", "dim", "No extensions installed."));
  for (const e of installed) {
    const name = e.name || e.filename;
    box.appendChild(rowItem(name, e.type || e.ext_type, [
      ["Uninstall", "danger", async ev => {
        if (!confirm(`Uninstall "${name}"?`)) return;
        ev.target.disabled = true;
        try {
          const r = await uninstallExtension(e.ext_type || "commands", e.filename);
          if (r && r.error) throw new Error(r.error);
          toast(`uninstalled ${name}`);
        } catch (err) {
          toast(`uninstall failed: ${err.message || err}`, true);
          ev.target.disabled = false;
          return;
        }
        loadExtensionsPanel();
      }],
    ]));
  }
  cat.innerHTML = "";
  const missing = (lib.catalog || []).filter(c => !installedNames.has(c.name));
  if ((lib.catalog || []).length && missing.length > 1) {
    const bulk = rowItem(`Install all (${missing.length})`,
      "everything in the catalog not installed yet", [
        ["Install all", "primary", async ev => {
          ev.target.disabled = true;
          let ok = 0, failed = 0;
          for (const c of missing) {
            try {
              const r = await installExtension(c.name);
              if (r && r.error) throw new Error(r.error);
              ok++;
            } catch (err) {
              failed++;
              toast(`${c.name}: ${err.message || err}`, true);
            }
          }
          toast(`installed ${ok}/${ok + failed} extensions`, failed > 0);
          loadExtensionsPanel();
        }],
      ]);
    cat.appendChild(bulk);
  }
  for (const c of lib.catalog || []) {
    const isInstalled = installedNames.has(c.name);
    const row = rowItem(c.name, c.description || "", isInstalled ? [] : [
      ["Install", "primary", async ev => {
        ev.target.textContent = "…";
        ev.target.disabled = true;
        try {
          const r = await installExtension(c.name);
          if (r && r.error) throw new Error(r.error);
          toast(`installed ${c.name}`);
        } catch (err) {
          toast(`install failed: ${err.message || err}`, true);
          ev.target.textContent = "Install";
          ev.target.disabled = false;
          return;
        }
        loadExtensionsPanel();
      }],
    ]);
    if (isInstalled)
      row.appendChild(el("span", "badge on", "installed ✓"));
    cat.appendChild(row);
  }
}

export function wireExtensionsPanel() {
  $("extensions-reload").onclick = async ev => {
    ev.target.textContent = "Reloading…";
    await reloadExtensions();
    invalidateCommandCatalog();  // user commands may have changed
    ev.target.textContent = "Reload extensions";
    loadExtensionsPanel();
  };
}
