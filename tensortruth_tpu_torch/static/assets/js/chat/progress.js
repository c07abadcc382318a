// In-message streaming progress (reference frontend
// components/chat/{StreamingIndicator,ToolPhaseIndicator,AgentProgress,
// ToolSteps}.tsx): a phase box with a playful per-status label while the
// pipeline works, and a LIVE tool-step timeline — each dispatched call
// appears with a spinner dot the moment the agent fans out
// (`tool_phase {calls}`), flips to ✓/✗ as its `tool_progress` lands, with
// params summary and click-to-expand output. The same renderer paints
// persisted history steps (collapsed, with the completed/failed counts).

import {el} from "../lib/dom.js";

// ---- phase box (StreamingIndicator + ToolPhaseIndicator) -------------------

// Playful per-status labels, stable while the status doesn't change
// (reference pickRandom kept per-status via useMemo).
export const STATUS_LABELS = {
  loading_models: ["Waking up the encoder…", "Paging weights into HBM…",
                   "Warming the MXU…"],
  retrieving: ["Hunting for clues…", "Scouring the knowledge base…",
               "Raiding the library…", "Mining for nuggets of wisdom…"],
  reranking: ["Separating wheat from chaff…", "Weighing the evidence…",
              "Judging the contenders…", "Assembling the dream team…"],
  thinking: ["Deep in thought…", "Connecting the dots…",
             "Engaging big brain mode…"],
  generating: ["Crafting the perfect response…", "Weaving words together…",
               "Summoning the muse…", "Typing with purpose…"],
};

export const PHASE_ICONS = {
  loading_models: "⏳", loading_model: "⏳", booting: "⚙",
  retrieving: "🔍", searching: "🔍", web_search: "🌐",
  reranking: "⚖", ranking: "⚖", ranking_titles: "⚖", ranking_content: "⚖",
  thinking: "🧠", analyzing: "🧠", summarizing: "🧠",
  generating: "✨", fetching: "⬇", fetched: "⬇", fitting: "✂",
  indexing: "🗄", processing: "⚙", tool_call: "🔧", complete: "✓",
};

let lastStatus = null, lastLabel = "Processing…";

export function phaseLabel(status) {
  if (status === lastStatus) return lastLabel;  // stable within a phase
  lastStatus = status;
  const pool = STATUS_LABELS[status];
  lastLabel = pool ? pool[Math.floor(Math.random() * pool.length)]
                   : (status ? status + "…" : "Processing…");
  return lastLabel;
}

// One phase box per streaming message, inserted above the body; message
// text (if given, e.g. a tool_phase's tool list) overrides the label pool.
export function showPhaseBox(stream, status, message) {
  if (!stream.assistant) return null;
  if (!stream.phaseBox) {
    stream.phaseBox = el("div", "phase-box");
    stream.phaseBox.appendChild(el("span", "phase-icon", ""));
    stream.phaseBox.appendChild(el("span", "phase-label", ""));
    stream.assistant.insertBefore(stream.phaseBox, stream.body);
  }
  stream.phaseBox.querySelector(".phase-icon").textContent =
    PHASE_ICONS[status] || "⏳";
  stream.phaseBox.querySelector(".phase-label").textContent =
    message || phaseLabel(status);
  return stream.phaseBox;
}

export function removePhaseBox(stream) {
  if (stream.phaseBox) stream.phaseBox.remove();
  stream.phaseBox = null;
}

// ---- live tool-step timeline (ToolSteps.tsx) -------------------------------

function normalizeStep(s) {
  // Persisted/legacy shape {tool, message, phase} → status-bearing shape.
  if (s.status) return s;
  return {
    tool: s.tool, params: s.params, output: s.output,
    message: s.message,
    status: s.phase === "failed" ? "failed" : "completed",
  };
}

export function paramsSummary(params) {
  if (!params) return "";
  return Object.entries(params).map(([k, v]) => {
    const val = typeof v === "string" ? v : JSON.stringify(v);
    return `${k}: ${val.length > 40 ? val.slice(0, 40) + "…" : val}`;
  }).join(", ");
}

const DOT = {calling: "⟳", completed: "✓", failed: "✗"};

// Render (or re-render in place) the timeline for a message. `live=true`
// keeps it expanded while the agent works; the done handler re-renders
// with live=false so history and finished streams share one collapsed look.
export function renderToolTimeline(container, steps, opts) {
  opts = opts || {};
  steps = (steps || []).map(normalizeStep);
  let box = container.querySelector(".timeline");
  if (!steps.length) { if (box) box.remove(); return null; }
  // Mid-stream rebuilds must not snap away what the user opened: remember
  // which rows had their output expanded, and (while live) whether the
  // list itself was collapsed, before replacing the DOM.
  const prevExpanded = new Set();
  let prevListOpen = null;
  if (box) {
    const prevList = box.querySelector(".tl-list");
    if (prevList) prevListOpen = prevList.style.display !== "none";
    box.querySelectorAll(".tl-row").forEach((row, i) => {
      const out = row.querySelector(".tl-out");
      if (out && out.style.display === "block") prevExpanded.add(i);
    });
  }
  if (box) box.remove();
  const listOpen = opts.live && prevListOpen !== null ? prevListOpen : !!opts.live;
  box = el("div", "timeline" + (opts.live ? " live" : ""));

  const completed = steps.filter(s => s.status === "completed").length;
  const failed = steps.filter(s => s.status === "failed").length;
  const running = steps.filter(s => s.status === "calling").length;
  const bits = [];
  if (completed) bits.push(`${completed} completed`);
  if (failed) bits.push(`${failed} failed`);
  if (running) bits.push(`${running} running`);
  const head = el("div", "tl-head");
  head.appendChild(el("span", "tl-title", `Steps (${steps.length})`));
  head.appendChild(el("span", "tl-counts", bits.join(" | ")));
  head.appendChild(el("span", "tl-caret", listOpen ? "▾" : "▸"));
  box.appendChild(head);

  const list = el("div", "tl-list");
  list.style.display = listOpen ? "block" : "none";
  head.onclick = () => {
    const open = list.style.display !== "none";
    list.style.display = open ? "none" : "block";
    head.querySelector(".tl-caret").textContent = open ? "▸" : "▾";
  };

  steps.forEach((s, i) => {
    const row = el("div", "tl-row " + s.status);
    const rail = el("span", "tl-rail");
    rail.appendChild(el("span", "tl-dot " + s.status, DOT[s.status] || "·"));
    if (i < steps.length - 1) rail.appendChild(el("span", "tl-line", ""));
    row.appendChild(rail);
    const main = el("div", "tl-main");
    const line = el("div", "tl-line1");
    line.appendChild(el("span", "tname", s.tool || "tool"));
    const ps = paramsSummary(s.params);
    if (ps) line.appendChild(el("span", "tl-params", " " + ps));
    else if (s.message && s.status !== "calling")
      line.appendChild(el("span", "tl-params", " — " + s.message));
    main.appendChild(line);
    const out = s.output || (ps ? s.message : null);
    if (out) {
      const pre = el("pre", "tl-out", String(out));
      pre.style.display = prevExpanded.has(i) ? "block" : "none";
      line.onclick = () => {
        pre.style.display = pre.style.display === "none" ? "block" : "none";
      };
      line.classList.add("expandable");
      main.appendChild(pre);
    }
    row.appendChild(main);
    list.appendChild(row);
  });
  box.appendChild(list);
  container.appendChild(box);
  return box;
}

// ---- live-step bookkeeping for ws.js ---------------------------------------

// tool_phase {calls:[{tool,params}]} (or legacy {tools:[names]}) → append
// "calling" steps for this iteration's parallel fan-out.
export function beginToolCalls(steps, msg) {
  const calls = msg.calls ||
    (msg.tools || []).map(t => ({tool: t, params: null}));
  for (const c of calls)
    steps.push({tool: c.tool, params: c.params, status: "calling"});
}

// tool_progress {tool, phase: completed|failed, output} → resolve the
// FIRST still-calling step of that tool (parallel same-tool calls resolve
// in dispatch order, like the reference's positional pairing). A progress
// event with no matching dispatch (the /web pipeline emits bare progress)
// appends a resolved step directly.
export function resolveToolCall(steps, msg) {
  // Phase-less progress (the /web pipeline's per-URL events) still signals
  // failure in its message prefix ("failed https://…", "ERROR: …") — don't
  // paint those with a green check.
  const failed = msg.phase === "failed" ||
    (!msg.phase && /^(error|failed)\b/i.test(msg.message || ""));
  const status = failed ? "failed" : "completed";
  // Field semantics are shared verbatim with the server's persistence
  // mirror (server/routes/chat.py mirror_tool_event; equivalence held by
  // a cross-language property test): output stays null when the event has
  // none — the renderer falls back to message at paint time.
  // same 2000-char cap as the server mirror — a reloaded session must
  // show the same output the live view painted
  const out = msg.output ? String(msg.output).slice(0, 2000) : null;
  for (const s of steps) {
    if (s.tool === msg.tool && s.status === "calling") {
      s.status = status;
      s.output = out;
      s.message = msg.message;
      return s;
    }
  }
  const s = {tool: msg.tool, message: msg.message, output: out, status};
  steps.push(s);
  return s;
}
