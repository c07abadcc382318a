// Outbound chat messages: the one place a user message enters the WS
// (composer submit and per-message resend both land here).

import {el, toast} from "../lib/dom.js";
import {addMessage} from "./messages.js";
import {isStreaming} from "./stream.js";
import {getWS} from "./ws.js";

// Send `text` (+ optional base64 images) over the open socket. Returns
// true when actually sent; callers clear their input only on success.
export function sendUserMessage(text, images) {
  const ws = getWS();
  if (!text || !ws || ws.readyState !== 1 || isStreaming()) return false;
  const wrap = addMessage("user", text);
  if (images && images.length)
    wrap.appendChild(el("div", "dim", `🖼 ${images.length} image(s)`));
  const payload = {message: text};
  if (images && images.length) payload.images = images;
  ws.send(JSON.stringify(payload));
  return true;
}

export function resendMessage(text) {
  sendUserMessage(text, null);
}

// First message of a freshly-opened session (project view's "Start chat"):
// the socket may still be CONNECTING right after connectWS — poll getWS()
// rather than pinning onopen to one socket instance, because a failed
// connect is replaced by a NEW socket via ws.js's 2 s auto-reconnect
// (reference: chatStore.pendingUserMessage drained by useChat once up).
export function sendWhenOpen(text) {
  const attempt = tries => {
    const ws = getWS();
    if (ws && ws.readyState === 1) { sendUserMessage(text, null); return; }
    if (tries > 0) setTimeout(() => attempt(tries - 1), 250);
    else toast("message not sent — chat connection never opened", true);
  };
  attempt(40);  // ~10 s window covers the auto-reconnect cycle
}
