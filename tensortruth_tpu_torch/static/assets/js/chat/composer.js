// Chat composer: message submit, image attachments for vision models,
// slash-command autocomplete (reference frontend CommandAutocomplete.tsx
// + ChatInput.tsx). Pending base64 images ride the WS message exactly like
// the reference's multimodal chat request (rag_service.py:431-443).

import {patchSessionRaw} from "../api/sessions.js";
import {listCommands} from "../api/tools.js";
import {$, el, toast} from "../lib/dom.js";
import {currentSessionId} from "../stores/session.js";
import {uploadDocument} from "../views/sidebar.js";
import {sendUserMessage} from "./send.js";

let pendingImages = [];   // raw base64, what rides the WS message
let pendingDataUrls = []; // same images as data: URLs, for the thumbnails

// Thumbnail strip with per-image remove (reference ImagePreviewStrip.tsx).
function renderAttachRow() {
  const row = $("attach-row");
  row.innerHTML = "";
  row.style.display = pendingImages.length ? "block" : "none";
  pendingDataUrls.forEach((url, i) => {
    const box = el("span", "attach-thumb");
    const img = document.createElement("img");
    img.src = url;
    box.appendChild(img);
    const x = el("span", "del", "×");
    x.title = "Remove image";
    x.onclick = () => {
      pendingImages.splice(i, 1);
      pendingDataUrls.splice(i, 1);
      renderAttachRow();
    };
    box.appendChild(x);
    row.appendChild(box);
  });
  if (pendingImages.length)
    row.appendChild(el("span", "dim", " sent with the next message"));
}

// Slash-command autocomplete: typing "/" with no space yet filters
// /api/commands by prefix; ArrowUp/Down navigate, Tab/Enter accept,
// Escape dismisses. Enter submits normally when the menu is closed.
let cmdList = null, cmdSel = 0, cmdShown = [];

export function invalidateCommandCatalog() { cmdList = null; }

async function commandCatalog() {
  if (cmdList === null) {
    try { cmdList = (await listCommands()).commands || []; }
    catch (e) { cmdList = []; }
  }
  return cmdList;
}

function hideCmdMenu() { $("cmd-menu").style.display = "none"; cmdShown = []; }

function acceptCmd(i) {
  const c = cmdShown[i];
  if (!c) return;
  $("input").value = "/" + c.name + " ";
  hideCmdMenu();
  $("input").focus();
}

function renderCmdMenu() {
  const m = $("cmd-menu"); m.innerHTML = "";
  cmdShown.forEach((c, i) => {
    const row = el("div", "cmd-item" + (i === cmdSel ? " sel" : ""), "");
    row.appendChild(el("span", "cname", "/" + c.name +
      (c.aliases && c.aliases.length ? " (" + c.aliases.map(a => "/" + a).join(", ") + ")" : "")));
    row.appendChild(el("span", "cdesc", c.description || ""));
    row.onmousedown = ev => { ev.preventDefault(); acceptCmd(i); };
    m.appendChild(row);
  });
  m.style.display = cmdShown.length ? "block" : "none";
}

async function updateCmdMenu() {
  const v = $("input").value;
  if (!v.startsWith("/") || v.includes(" ") || v.includes("\n")) { hideCmdMenu(); return; }
  const prefix = v.slice(1).toLowerCase();
  const all = await commandCatalog();
  cmdShown = all.filter(c =>
    c.name.toLowerCase().startsWith(prefix) ||
    (c.aliases || []).some(a => a.toLowerCase().startsWith(prefix)));
  cmdSel = Math.min(cmdSel, Math.max(0, cmdShown.length - 1));
  renderCmdMenu();
}

// Composer thinking quick-select (reference ThinkingSelect.tsx): mirrors
// params.thinking without opening the drawer; "" = auto (provider decides).
export function syncThinkingSelect(params) {
  const t = params.thinking;
  $("thinking-select").value = t === undefined || t === null ? "" : String(t);
}

async function onThinkingPick() {
  if (!currentSessionId()) return;
  const v = $("thinking-select").value;
  const thinking = v === "" ? null : v === "true" ? true : v === "false" ? false : v;
  const r = await patchSessionRaw(currentSessionId(), {params: {thinking}});
  if (!r.ok) toast(`thinking change failed (${r.status})`, true);
}

export function wireComposer() {
  $("thinking-select").onchange = onThinkingPick;
  // One attach path for picker, clipboard paste, and drag-drop (reference
  // useImageAttachment.ts: handleFileSelect / handlePaste / handleDrop).
  const attachFile = file => {
    if (!file || !file.type || !file.type.startsWith("image/")) return false;
    const reader = new FileReader();
    reader.onload = () => {
      pendingDataUrls.push(String(reader.result));
      pendingImages.push(String(reader.result).split(",", 2)[1]);  // strip data: prefix
      renderAttachRow();
    };
    reader.readAsDataURL(file);
    return true;
  };
  $("attach-btn").onclick = () => $("image-input").click();
  $("image-input").onchange = ev => {
    const files = [...ev.target.files];
    ev.target.value = "";
    for (const f of files) attachFile(f);
  };
  $("input").addEventListener("paste", ev => {
    const items = ev.clipboardData && ev.clipboardData.items;
    for (const it of items || []) {
      if (it.type && it.type.startsWith("image/") && attachFile(it.getAsFile()))
        ev.preventDefault();  // keep the image out of the textarea as text
    }
  });
  // Drop routing (reference DocumentUploader drop zone + image attach):
  // images attach to the next message; documents (.pdf/.md/.txt/.html)
  // upload-and-index into the open session. Works on the composer AND the
  // message area, with a visual drop hint.
  const DOC_EXT = /\.(pdf|md|txt|html)$/i;
  const routeDrop = files => {
    for (const f of files) {
      if (attachFile(f)) continue;
      if (f && f.name && DOC_EXT.test(f.name)) {
        if (!currentSessionId()) {
          // the drop affordance invited it — never swallow silently
          toast("open a session first to index dropped documents", true);
          continue;
        }
        uploadDocument(f);
      } else if (f && f.name) toast(`unsupported file type: ${f.name}`, true);
    }
  };
  for (const zone of [$("composer"), $("messages")]) {
    zone.addEventListener("dragover", ev => {
      ev.preventDefault();
      zone.classList.add("dragging");
    });
    zone.addEventListener("dragleave", ev => {
      // crossing onto a child fires dragleave on the zone; only clear the
      // hint when the pointer actually left the zone subtree
      if (ev && ev.relatedTarget && zone.contains && zone.contains(ev.relatedTarget))
        return;
      zone.classList.remove("dragging");
    });
    zone.addEventListener("drop", ev => {
      ev.preventDefault();
      zone.classList.remove("dragging");
      routeDrop((ev.dataTransfer && ev.dataTransfer.files) || []);
    });
  }

  $("composer").onsubmit = ev => {
    ev.preventDefault();
    const text = $("input").value.trim();
    // The Enter key bypasses the hidden send button, so sendUserMessage
    // guards mid-stream submits: the server would reject with a busy error
    // that corrupts the live stream display, and the typed message would be
    // dropped.
    if (!currentSessionId()) return;
    if (!sendUserMessage(text, pendingImages)) return;
    pendingImages = [];
    pendingDataUrls = [];
    renderAttachRow();
    $("input").value = "";
    $("input").style.height = "48px";  // collapse the autosized draft box
  };

  $("input").addEventListener("input", () => {
    updateCmdMenu();
    // Autosize (reference ChatInput.tsx textarea growth): the composer
    // grows with the draft up to ~6 lines, then scrolls; resets on submit.
    const ta = $("input");
    ta.style.height = "auto";
    ta.style.height = Math.min(160, Math.max(48, ta.scrollHeight)) + "px";
  });
  $("input").addEventListener("blur", () => setTimeout(hideCmdMenu, 150));
  $("input").addEventListener("keydown", ev => {
    const open = cmdShown.length && $("cmd-menu").style.display !== "none";
    if (open) {
      if (ev.key === "ArrowDown") { ev.preventDefault(); cmdSel = (cmdSel + 1) % cmdShown.length; renderCmdMenu(); return; }
      if (ev.key === "ArrowUp") { ev.preventDefault(); cmdSel = (cmdSel - 1 + cmdShown.length) % cmdShown.length; renderCmdMenu(); return; }
      if (ev.key === "Tab" || ev.key === "Enter") { ev.preventDefault(); acceptCmd(cmdSel); return; }
      if (ev.key === "Escape") { ev.preventDefault(); hideCmdMenu(); return; }
    }
    if (ev.key === "Enter" && !ev.shiftKey) { ev.preventDefault(); $("composer").requestSubmit(); }
  });
}
