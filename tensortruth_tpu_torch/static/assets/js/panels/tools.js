// Tools panel (reference components/config/tools): loaded agent tools,
// registered slash commands (with aliases), named agents.

import {listAgents, listCommands, listTools} from "../api/tools.js";
import {$, el} from "../lib/dom.js";
import {rowItem} from "../views/manage.js";

export async function loadToolsPanel() {
  const [tools, commands, agents] = await Promise.all([
    listTools().catch(() => ({tools: []})),
    listCommands().catch(() => ({commands: []})),
    listAgents().catch(() => ({agents: []})),
  ]);
  const tb = $("tools-list"); tb.innerHTML = "";
  if (!(tools.tools || []).length) tb.appendChild(el("div", "dim", "No tools loaded."));
  for (const t of tools.tools || [])
    tb.appendChild(rowItem(t.name, t.description || "", []));
  const cb = $("commands-list"); cb.innerHTML = "";
  for (const c of commands.commands || [])
    cb.appendChild(rowItem("/" + c.name, `${c.description || ""}${c.aliases?.length ? " · aliases: " + c.aliases.join(", ") : ""}`, []));
  const ab = $("agents-list"); ab.innerHTML = "";
  if (!(agents.agents || []).length) ab.appendChild(el("div", "dim", "No named agents registered."));
  for (const a of agents.agents || [])
    ab.appendChild(rowItem(a.name || a, a.description || "", []));
}
