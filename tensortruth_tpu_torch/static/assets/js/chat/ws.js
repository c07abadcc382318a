// WS chat protocol (reference hooks/useWebSocket.ts + useChat.ts).
// One handler per server message type (server/routes/chat.py + orchestrator
// emit: token, thinking, reasoning, status, tool_phase, tool_progress,
// sources, done, error, title, confirmation_request). Handlers close over
// the live streaming state held in stream.js.

import {$, scrollMessages, toast} from "../lib/dom.js";
import {renderConfirmationCard} from "./confirmcard.js";
import {renderMarkdown} from "../lib/markdown.js";
import {currentSessionId} from "../stores/session.js";
import {loadSessions} from "../views/sidebar.js";
import {
  decorateCodeBlocks, renderMetrics, renderSources, renderStats,
  renderThinking,
} from "./messages.js";
import {
  beginToolCalls, removePhaseBox, renderToolTimeline, resolveToolCall,
  showPhaseBox,
} from "./progress.js";
import {clearReasoning, ensureAssistant, resetStream, stream} from "./stream.js";

let ws = null;

export function getWS() { return ws; }

const WS_HANDLERS = {
  status(msg) {
    $("statusline").textContent = (msg.status || "") + "…";
    // In-message phase box (reference StreamingIndicator.tsx): a concrete
    // server message ("Fetching pages", the /web pipeline) wins over the
    // playful per-status label pool; removed when the first token lands.
    ensureAssistant();
    showPhaseBox(stream, msg.status, msg.message);
  },
  tool_phase(msg) {
    $("statusline").textContent = "tools: " + (msg.tools || []).join(", ");
    ensureAssistant();
    // every dispatched call appears immediately as a spinner row in the
    // live timeline (reference ToolSteps with status "calling")
    beginToolCalls(stream.toolSteps, msg);
    renderToolTimeline(stream.assistant, stream.toolSteps, {live: true});
    showPhaseBox(stream, "tool_call", "running " + (msg.tools || []).join(", "));
  },
  tool_progress(msg) {
    $("statusline").textContent = msg.message || msg.tool || "";
    ensureAssistant();
    resolveToolCall(stream.toolSteps, msg);
    renderToolTimeline(stream.assistant, stream.toolSteps, {live: true});
  },
  reasoning(msg) {
    // Agent phase-1 reasoning deltas (orchestrator show_orchestrator_reasoning,
    // agents/function_agent.py). Ephemeral like the reference's
    // appendReasoning/clearReasoning pair (useWebSocket.ts): shown in a
    // thinking-style box while the agent plans, removed once synthesis
    // thinking or the first answer token arrives; never persisted.
    ensureAssistant();
    if (!stream.reasoningBox) {
      stream.reasoningBox = renderThinking(stream.assistant, "",
                                           {before: stream.body, open: true});
      stream.reasoningBox.querySelector("summary").textContent = "reasoning";
    }
    stream.reasoningText += msg.content;
    stream.reasoningBox.querySelector(".tbody").textContent = stream.reasoningText;
  },
  thinking(msg) {
    ensureAssistant();
    clearReasoning();
    if (!stream.thinkingBox)
      stream.thinkingBox = renderThinking(stream.assistant, "",
                                          {before: stream.body, open: true});
    stream.thinkingText += msg.content;
    const tbody = stream.thinkingBox.querySelector(".tbody");
    tbody.textContent = stream.thinkingText;
    tbody.scrollTop = tbody.scrollHeight;  // keep the live tail visible
  },
  token(msg) {
    ensureAssistant();
    clearReasoning();
    removePhaseBox(stream);
    // Incremental markdown: accumulate raw text and repaint at most every
    // 120 ms. The repaint is block-memoized (lib/mdstream.js ≡ reference
    // MemoizedMarkdown.tsx): finished blocks keep their DOM; only the open
    // tail block re-parses, so long answers stay O(tail) per repaint.
    stream.raw += msg.content;
    if (!stream.renderTimer) {
      stream.renderTimer = setTimeout(() => {
        stream.renderTimer = 0;
        if (!stream.body) return; // stream ended while the repaint was pending
        stream.body.classList.add("md");
        stream.repaint(stream.raw);
        scrollMessages();
      }, 120);
    }
    scrollMessages();
  },
  sources(msg) {
    ensureAssistant();
    renderSources(stream.assistant, msg.sources);
  },
  done(msg) {
    ensureAssistant();
    clearReasoning();
    removePhaseBox(stream);
    $("statusline").textContent = "";
    stream.body.classList.add("md");
    stream.body.innerHTML = renderMarkdown(msg.content || stream.raw);
    decorateCodeBlocks(stream.body);
    if (stream.thinkingBox) stream.thinkingBox.open = false;
    // re-render the live timeline collapsed, with final counts
    renderToolTimeline(stream.assistant, stream.toolSteps, {live: false});
    renderMetrics(stream.assistant, msg.metrics, msg.confidence);
    renderStats(stream.assistant, msg.stats);
    resetStream();
  },
  error(msg) {
    ensureAssistant();
    clearReasoning();
    removePhaseBox(stream);
    $("statusline").textContent = "";
    stream.body.textContent = stream.raw + "⚠ " + msg.error;
    toast(msg.error, true);
    resetStream();
  },
  title() { loadSessions(); },
  confirmation_request(msg) {
    // Inline approval card (reference ConfirmationCard.tsx): action chip,
    // target, config detail block, busy/error states; the card stays with
    // its decision badge while the orchestrator resumes.
    renderConfirmationCard(msg);
  },
};

export function connectWS() {
  const proto = location.protocol === "https:" ? "wss" : "ws";
  ws = new WebSocket(`${proto}://${location.host}/ws/chat/${currentSessionId()}`);
  resetStream();
  ws.onmessage = ev => {
    const msg = JSON.parse(ev.data);
    (WS_HANDLERS[msg.type] || (() => {}))(msg);
  };
  ws.onclose = () => {
    // auto-reconnect for the still-open session (heartbeat drops, restarts)
    if (currentSessionId()) setTimeout(() => {
      if (ws && ws.readyState === 3 && currentSessionId()) connectWS();
    }, 2000);
  };
}

export function closeWS() {
  if (ws) { ws.onclose = null; ws.close(); ws = null; }
}

// Stop streaming: a protocol-level {"type":"stop"} keeps the socket alive
// (the server cancels its generator and answers with a cancelled done);
// fall back to close+reconnect if the socket is wedged. Richer than the
// reference's cancelStreaming (hooks/useWebSocket.ts:272), which only
// closes the socket.
export function stopStreaming() {
  $("statusline").textContent = "stopping…";
  if (ws && ws.readyState === 1) {
    ws.send(JSON.stringify({type: "stop"}));
  } else {
    closeWS();
    resetStream();
    if (currentSessionId()) connectWS();
  }
}
