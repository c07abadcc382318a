// DOM helpers shared by every view module.
// (Reference keeps equivalents in frontend/src/lib/utils.ts.)

export function $(id) { return document.getElementById(id); }

export function el(tag, cls, text) {
  const e = document.createElement(tag);
  if (cls) e.className = cls;
  if (text !== undefined) e.textContent = text;
  return e;
}

export function toast(message, isError) {
  const t = el("div", "toast" + (isError ? " error" : ""), message);
  $("toasts").appendChild(t);
  setTimeout(() => t.remove(), 4500);
}

// Autoscroll that respects the reader: stick to the bottom only when the
// user is already there (within a small margin), so scrolling up to reread
// isn't yanked away by the next streamed token. force=true (own message
// sent, session opened) always scrolls. Reference useAutoScroll.ts.
export function scrollMessages(force) {
  const box = $("messages");
  const nearBottom =
    box.scrollHeight - box.scrollTop - box.clientHeight < 160;
  if (force || nearBottom) box.scrollTop = box.scrollHeight;
}
