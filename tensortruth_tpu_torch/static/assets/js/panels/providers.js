// Providers panel (reference components/providers/ProviderSetupPanel.tsx,
// ProviderCard.tsx, AddProviderDialog.tsx, DiscoveryBanner.tsx): CRUD with
// form validation, per-provider reachability badges probed in the
// background on load (discovery banner), a three-state Test button that
// surfaces the failure reason, inline base-URL editing, model discovery,
// and set-as-session-model.

import {
  addProvider, deleteProvider, discoverModels, listProviders, patchProvider,
  testProvider,
} from "../api/providers.js";
import {patchSession} from "../api/sessions.js";
import {$, el, toast} from "../lib/dom.js";
import {currentSessionId} from "../stores/session.js";
import {rowItem} from "../views/manage.js";

// id -> {ok, models, error} from the last background probe; badges render
// from this so a panel re-load doesn't re-probe every provider.
const probeCache = new Map();

function reachBadge(p) {
  const probe = probeCache.get(p.id);
  let cls = "badge", txt = "untested";
  if (probe) {
    cls = "badge" + (probe.ok ? " on" : " err");
    txt = probe.ok ? `reachable · ${probe.models.length} models` : "unreachable";
  }
  const b = el("span", cls, txt);
  if (probe && !probe.ok) b.title = probe.error || "";
  return b;
}

async function probeProvider(p) {
  const r = await testProvider({
    type: p.type, base_url: p.base_url, api_key: p.api_key,
  }).catch(e => ({ok: false, error: String(e)}));
  probeCache.set(p.id, {ok: !!r.ok, models: r.models || [], error: r.error});
  return probeCache.get(p.id);
}

export async function loadProvidersPanel() {
  const data = await listProviders();
  const box = $("providers-list"); box.innerHTML = "";
  if (!data.providers.length) box.appendChild(el("div", "dim", "No providers configured."));
  for (const p of data.providers) {
    const d = rowItem(`${p.id}`, `${p.type} · ${p.base_url || "default URL"}`, [
      [p.enabled ? "Disable" : "Enable", "", async () => {
        await patchProvider(p.id, {enabled: !p.enabled});
        loadProvidersPanel();
      }],
      ["Test", "", async ev => {
        // three states (reference ProviderCard): testing -> ok/fail+reason
        ev.target.textContent = "Testing…";
        ev.target.disabled = true;
        const probe = await probeProvider(p);
        ev.target.disabled = false;
        if (probe.ok) {
          ev.target.textContent = `✓ OK (${probe.models.length} models)`;
        } else {
          ev.target.textContent = "✗ failed";
          ev.target.title = probe.error || "";
          toast(`${p.id}: ${probe.error || "unreachable"}`, true);
        }
        refreshBadge(d, p);
      }],
      ["Edit URL", "", async ev => {
        const url = prompt(`Base URL for ${p.id}:`, p.base_url || "");
        if (url === null) return;
        if (url && !/^https?:\/\//.test(url)) {
          toast("base URL must start with http:// or https://", true);
          return;
        }
        await patchProvider(p.id, {base_url: url});
        probeCache.delete(p.id);
        loadProvidersPanel();
      }],
      ["Models", "", async () => showProviderModels(p.id)],
      ["Delete", "danger", async () => {
        if (!confirm(`Delete provider ${p.id}?`)) return;
        await deleteProvider(p.id);
        probeCache.delete(p.id);
        loadProvidersPanel();
      }],
    ]);
    d.dataset.providerId = p.id;
    const enabled = el("span", "badge" + (p.enabled ? " on" : ""), p.enabled ? "enabled" : "disabled");
    d.insertBefore(enabled, d.children[1]);
    d.insertBefore(reachBadge(p), d.children[2]);
    box.appendChild(d);
  }
  discoveryBanner(data.providers);
}

function refreshBadge(row, p) {
  const old = row.querySelectorAll(".badge")[1];
  if (old) old.replaceWith(reachBadge(p));
}

// Background reachability sweep over ENABLED providers that have not been
// probed yet (reference DiscoveryBanner): badges fill in as probes land,
// without blocking the panel render.
function discoveryBanner(providers) {
  for (const p of providers) {
    if (!p.enabled || probeCache.has(p.id)) continue;
    probeProvider(p).then(() => {
      const row = document.querySelector(
        `#providers-list [data-provider-id="${CSS.escape(p.id)}"]`);
      if (row) refreshBadge(row, p);
    });
  }
}

export async function showProviderModels(providerId) {
  const box = $("provider-models"); box.innerHTML = "";
  box.appendChild(el("div", "dim", "discovering…"));
  try {
    const data = await discoverModels(providerId);
    box.innerHTML = "";
    const models = data[providerId] || [];
    if (!models.length) box.appendChild(el("div", "dim", "No models reported by this provider."));
    for (const m of models) {
      const name = m.id || m.name || m;
      const row = rowItem(String(name), m.details || "", [
        ["Use in session", "primary", async () => {
          if (!currentSessionId()) return;
          await patchSession(currentSessionId(), {params: {model: String(name)}});
          $("statusline").textContent = `session model → ${name}`;
        }],
      ]);
      box.appendChild(row);
    }
  } catch (e) {
    box.innerHTML = "";
    box.appendChild(el("div", "dim", "discover failed: " + e));
  }
}

// Pre-flight validation mirroring the server's schema plus the checks the
// reference's AddProviderDialog runs client-side.
export function validateProviderForm(body) {
  if (!body.id || !/^[A-Za-z0-9._-]+$/.test(body.id)) {
    return "id must be a slug (letters, digits, . _ -)";
  }
  if (body.base_url && !/^https?:\/\/\S+$/.test(body.base_url)) {
    return "base URL must be http(s)://…";
  }
  if (body.type === "openai_compatible" && !body.base_url) {
    return "openai_compatible providers need a base URL";
  }
  return null;
}

export function wireProvidersPanel() {
  $("provider-form").onsubmit = async ev => {
    ev.preventDefault();
    const f = new FormData(ev.target);
    const body = Object.fromEntries(f);
    const err = validateProviderForm(body);
    if (err) { toast(err, true); return; }
    let r;
    try {
      r = await addProvider(body);
    } catch (e) {
      toast(`add failed: ${e}`, true);
      return;
    }
    if (r && (r.error || r.detail)) {  // server-side validation rejection
      toast(`add failed: ${r.error || r.detail}`, true);
      return;
    }
    ev.target.reset();
    loadProvidersPanel();
  };
}
