// Live streaming state for the open WS chat (reference keeps the
// equivalent inside hooks/useChat.ts). One assistant message streams at a
// time; handlers in ws.js close over this state, the composer consults
// isStreaming() to block mid-stream submits.

import {$} from "../lib/dom.js";
import {createStreamRenderer} from "../lib/mdstream.js";
import {addMessage} from "./messages.js";

export const stream = {
  assistant: null, body: null, thinkingText: "", thinkingBox: null, toolSteps: [],
  reasoningText: "", reasoningBox: null, // ephemeral agent phase-1 reasoning
  phaseBox: null,    // in-message pipeline-phase indicator (chat/progress.js)
  raw: "",           // accumulated assistant text, re-rendered incrementally
  renderTimer: 0,    // pending throttled markdown repaint (ws.js token handler)
  repaint: null,     // per-message memoized block renderer (lib/mdstream.js)
};

let streaming = false;

export function isStreaming() { return streaming; }

export function setStreaming(on) {
  streaming = on;
  $("stop-btn").style.display = on ? "" : "none";
  $("send-btn").style.display = on ? "none" : "";
}

export function ensureAssistant() {
  if (!stream.assistant) {
    stream.assistant = addMessage("assistant", "");
    stream.body = stream.assistant.querySelector(".body");
    stream.thinkingText = "";
    stream.thinkingBox = null;
    stream.reasoningText = "";
    stream.reasoningBox = null;
    stream.toolSteps = [];
    stream.raw = "";
    stream.repaint = createStreamRenderer(stream.body);
    setStreaming(true);
  }
}

// Remove the ephemeral phase-1 reasoning box (reference clearReasoning():
// agent reasoning is never persisted; it yields to thinking or the answer).
export function clearReasoning() {
  if (stream.reasoningBox) stream.reasoningBox.remove();
  stream.reasoningBox = null;
  stream.reasoningText = "";
}

export function resetStream() {
  if (stream.renderTimer) { clearTimeout(stream.renderTimer); stream.renderTimer = 0; }
  // a wedged-socket reset (ws.js stopStreaming fallback) may fire with the
  // reasoning box still attached — nulling the reference without removing
  // the node would orphan the never-persisted box in the message DOM
  clearReasoning();
  if (stream.phaseBox) stream.phaseBox.remove();
  stream.phaseBox = null;
  stream.assistant = stream.body = stream.thinkingBox = stream.repaint = null;
  stream.thinkingText = "";
  stream.reasoningText = "";
  stream.toolSteps = [];
  stream.raw = "";
  setStreaming(false);
}
