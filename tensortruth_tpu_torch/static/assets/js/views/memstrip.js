// Sidebar memory monitor (reference frontend
// components/status/MemoryMonitor.tsx): a compact always-visible strip
// showing device HBM in use vs limit and host RAM pressure, refreshed on
// an interval; clicking it opens the full System panel.

import {systemMemory} from "../api/system.js";
import {$} from "../lib/dom.js";
import {showManage} from "./manage.js";

const POLL_MS = 20000;
let timer = null;

function fmtGB(bytes) {
  return bytes == null ? "?" : (bytes / 1024 ** 3).toFixed(1);
}

async function refresh() {
  let data;
  try { data = await systemMemory(); }
  catch (e) { $("memstrip").style.display = "none"; return; }
  const strip = $("memstrip");
  strip.style.display = "block";
  const dev = (data.devices || [])[0] || {};
  const used = dev.bytes_in_use, limit = dev.bytes_limit;
  const pct = used != null && limit ? Math.min(100, 100 * used / limit) : 0;
  strip.querySelector(".mem-label").textContent =
    `${dev.kind || dev.platform || "device"} ${fmtGB(used)}/${fmtGB(limit)} GB · RAM ${Math.round(data.ram?.percent ?? 0)}%`;
  const bar = strip.querySelector(".mem-bar div");
  bar.style.width = `${pct}%`;
  bar.style.background = pct > 90 ? "var(--err)" : "var(--accent)";
}

export function wireMemstrip() {
  $("memstrip").onclick = () => showManage(true, "system");
  refresh();
  timer = setInterval(refresh, POLL_MS);
}

export function stopMemstrip() {  // for tests / teardown symmetry
  if (timer) clearInterval(timer);
  timer = null;
}
