// MCP panel (reference components/config/McpServersSection.tsx): configured
// MCP servers with connection-state detail, edit-in-place via PATCH, a
// preset picker that auto-fills the form (command/args/env), an env editor
// (KEY=VALUE per line), per-transport validation, and conflict/error
// surfacing.

import {
  addMcpServer, deleteMcpServer, listMcpServers, mcpPresets, patchMcpServer,
  toggleMcpServer,
} from "../api/mcp.js";
import {$, el, toast} from "../lib/dom.js";
import {rowItem} from "../views/manage.js";

let presetList = [];
let editing = null;  // server name while the form is in edit mode

export function parseEnvLines(text) {
  // KEY=VALUE per line (reference ServerDialog.parseEnv); returns
  // {env, error} — a line without '=' is a user mistake worth naming.
  const env = {};
  for (const line of String(text || "").split("\n")) {
    const t = line.trim();
    if (!t) continue;
    const i = t.indexOf("=");
    if (i <= 0) return {env: null, error: `env line needs KEY=VALUE: "${t}"`};
    env[t.slice(0, i)] = t.slice(i + 1);
  }
  return {env, error: null};
}

export function validateMcpForm(body) {
  if (!body.name || !/^[\w.-]+$/.test(body.name)) {
    return "name must be a slug (letters, digits, . _ -)";
  }
  if (body.transport === "stdio" && !body.command) {
    return "stdio servers need a command";
  }
  if (body.transport !== "stdio" && !/^https?:\/\/\S+$/.test(body.url || "")) {
    return `${body.transport} servers need an http(s) url`;
  }
  return null;
}

function fillForm(values) {
  const form = $("mcp-form");
  form.elements.name.value = values.name || "";
  form.elements.transport.value = values.transport || "stdio";
  form.elements.command.value = values.command || "";
  form.elements.args.value = (values.args || []).join(" ");
  form.elements.url.value = values.url || "";
  form.elements.env.value = Object.entries(values.env || {})
    .map(([k, v]) => `${k}=${v}`).join("\n");
}

function setEditMode(name) {
  editing = name;
  $("mcp-submit").textContent = name ? `Update ${name}` : "Add server";
  $("mcp-cancel-edit").style.display = name ? "" : "none";
  $("mcp-form").elements.name.disabled = !!name;  // name is the identity
}

export async function loadMcpPanel() {
  const [servers, presets] = await Promise.all([
    listMcpServers(), mcpPresets().catch(() => ({presets: []})),
  ]);
  presetList = presets.presets || [];
  const box = $("mcp-list"); box.innerHTML = "";
  if (!(servers.servers || []).length) box.appendChild(el("div", "dim", "No MCP servers configured."));
  for (const s of servers.servers || []) {
    // Surface config errors (bad transport, missing url/command) and the
    // last connect attempt's outcome so a server silently loading zero
    // tools is visible here, not just in server logs.
    let detail = `${s.transport || "stdio"} · ${s.command || s.url || ""}`;
    if (s.config_error) detail += ` · ⚠ ${s.config_error}`;
    else if (s.connection?.status === "error") detail += ` · ⚠ ${s.connection.error}`;
    else if (s.connection?.status === "connected")
      detail += ` · ✓ ${s.connection.n_tools} tools`;
    const row = rowItem(s.name, detail, [
      [s.enabled ? "Disable" : "Enable", "", async () => {
        await toggleMcpServer(s.name);
        loadMcpPanel();
      }],
      ["Edit", "", () => {
        fillForm(s);
        setEditMode(s.name);
      }],
      ["Delete", "danger", async () => {
        if (!confirm(`Delete MCP server ${s.name}?`)) return;
        await deleteMcpServer(s.name);
        if (editing === s.name) { setEditMode(null); $("mcp-form").reset(); }
        loadMcpPanel();
      }],
    ]);
    const state = s.config_error || s.connection?.status === "error"
      ? ["err", "error"]
      : s.connection?.status === "connected" ? ["on", "connected"]
      : ["", s.enabled ? "enabled" : "disabled"];
    row.insertBefore(el("span", `badge ${state[0]}`.trim(), state[1]), row.children[1]);
    box.appendChild(row);
  }
  const sel = $("mcp-preset-select");
  sel.innerHTML = "";
  sel.appendChild(el("option", "", "custom…"));
  for (const p of presetList) {
    const opt = el("option", "", p.name);
    opt.value = p.name;
    sel.appendChild(opt);
  }
}

export function wireMcpPanel() {
  // preset pick auto-fills the form (reference handlePresetChange) — the
  // user still reviews/edits before submitting
  $("mcp-preset-select").onchange = ev => {
    const p = presetList.find(x => x.name === ev.target.value);
    if (p) { fillForm(p); setEditMode(null); }
  };
  $("mcp-cancel-edit").onclick = ev => {
    ev.preventDefault();
    setEditMode(null);
    $("mcp-form").reset();
  };
  $("mcp-form").onsubmit = async ev => {
    ev.preventDefault();
    const f = new FormData(ev.target);
    const {env, error: envError} = parseEnvLines(
      ev.target.elements.env.value);
    if (envError) { toast(envError, true); return; }
    const body = {
      name: editing || f.get("name"),
      transport: f.get("transport") || "stdio",
      command: f.get("command") || "",
      url: f.get("url") || "",
      args: (f.get("args") || "").split(/\s+/).filter(Boolean),
      env,
    };
    const err = validateMcpForm(body);
    if (err) { toast(err, true); return; }
    try {
      if (editing) {
        const {name, ...patch} = body;
        await patchMcpServer(editing, patch);
        toast(`updated ${editing}`);
      } else {
        const r = await addMcpServer(body);
        if (r && (r.error || r.detail)) throw new Error(r.error || r.detail);
        toast(`added ${body.name}`);
      }
    } catch (e) {
      toast(`save failed: ${e.message || e}`, true);
      return;
    }
    setEditMode(null);
    ev.target.reset();
    loadMcpPanel();
  };
}
