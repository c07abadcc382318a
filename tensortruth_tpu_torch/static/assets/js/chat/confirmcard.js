// Inline tool-confirmation card (reference frontend
// components/chat/ConfirmationCard.tsx): action chip colored per MCP
// action, target name, a monospace config-detail block, Approve/Reject
// with busy state and error surfacing — and the card STAYS after the
// decision with an Approved/Rejected badge instead of vanishing.

import {approveConfirmation, rejectConfirmation} from "../api/confirmations.js";
import {el, scrollMessages, $} from "../lib/dom.js";

export const ACTION_LABELS = {
  mcp_add: "Add", mcp_update: "Update", mcp_remove: "Remove",
};

function detailBlock(details) {
  const box = el("div", "cc-details");
  const config = details.config || {};
  const put = (k, v) => box.appendChild(el("div", "", `${k}: ${v}`));
  if (config.type != null) put("Type", String(config.type));
  if (config.command != null)
    put("Command", String(config.command) +
        (Array.isArray(config.args) ? " " + config.args.join(" ") : ""));
  if (config.url != null) put("URL", String(config.url));
  if (config.description != null) put("Description", String(config.description));
  if (config.env != null && typeof config.env === "object")
    put("Env", Object.keys(config.env).join(", "));
  if (!box.children.length) {
    // generic (non-MCP) confirmations: dump all detail entries
    for (const [k, v] of Object.entries(details)) {
      if (k === "config") continue;
      put(k, typeof v === "object" ? JSON.stringify(v) : String(v));
    }
  }
  return box.children.length ? box : null;
}

export function renderConfirmationCard(msg) {
  const card = el("div", "confirm-card");
  const action = msg.action_type || "confirm";
  const isMcp = action.startsWith("mcp_");

  const head = el("div", "cc-head");
  head.appendChild(el("span", "", isMcp ? "🖧" : "🛡"));
  head.appendChild(el("span", "cc-chip " + action,
    ACTION_LABELS[action] || action));
  head.appendChild(el("span", "cc-target",
    msg.title || msg.tool || "tool request"));
  const statusBadge = el("span", "cc-status", "");
  head.appendChild(statusBadge);
  card.appendChild(head);

  card.appendChild(el("p", "dim cc-summary",
    msg.message || msg.description || ""));

  if (msg.details && action !== "mcp_remove") {
    const block = detailBlock(msg.details);
    if (block) card.appendChild(block);
  }

  const errLine = el("p", "cc-error", "");
  errLine.style.display = "none";
  card.appendChild(errLine);

  const row = el("div", "cc-actions");
  const yes = el("button", "hbtn primary", "✓ Approve");
  const no = el("button", "hbtn", "✕ Reject");
  const decide = async (fn, label, cls) => {
    yes.disabled = no.disabled = true;
    errLine.style.display = "none";
    try {
      await fn(msg.confirmation_id);
      row.remove();
      statusBadge.textContent = label;
      statusBadge.classList.add(cls);
    } catch (e) {
      errLine.textContent = String(e && e.message || e);
      errLine.style.display = "block";
      yes.disabled = no.disabled = false;
    }
  };
  yes.onclick = () => decide(approveConfirmation, "Approved", "ok");
  no.onclick = () => decide(rejectConfirmation, "Rejected", "no");
  row.appendChild(yes);
  row.appendChild(no);
  card.appendChild(row);

  $("messages").appendChild(card);
  scrollMessages(true);
  return card;
}
