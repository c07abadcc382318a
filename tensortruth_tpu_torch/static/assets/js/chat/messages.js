// Message rendering: bubbles, per-message actions, sources, retrieval
// metrics, tool-step timeline, thinking blocks (reference
// frontend/src/components/chat/*). Pure render helpers — streaming state
// lives in stream.js, the socket in ws.js.

import {api} from "../api/client.js";
import {deleteMessage} from "../api/sessions.js";
import {$, el, scrollMessages, toast} from "../lib/dom.js";
import {safeUrl} from "../lib/markdown.js";
import {renderToolTimeline} from "./progress.js";
import {currentSessionId, sessionStore} from "../stores/session.js";
import {openProjectView} from "../views/project.js";
import {resendMessage} from "./send.js";

export function copyText(text) {
  if (navigator.clipboard && navigator.clipboard.writeText)
    return navigator.clipboard.writeText(text).then(() => toast("copied"));
  const ta = document.createElement("textarea");
  ta.value = text;
  document.body.appendChild(ta);
  ta.select();
  document.execCommand("copy");
  ta.remove();
  toast("copied");
}

// Fenced code blocks get a top-right copy button + language label
// (reference MemoizedMarkdown.tsx CodeCopyButton / CodeBlock wrapper).
// Runs over an already-rendered .body — the renderer's HTML stays
// identical to the Python twin; decoration is a DOM-side concern.
export function decorateCodeBlocks(body) {
  if (!body || !body.querySelectorAll) return;
  for (const pre of body.querySelectorAll("pre")) {
    if (pre.querySelector && pre.querySelector(".code-copy")) continue;
    const code = pre.querySelector && pre.querySelector("code");
    // fence languages may carry +/#/./- ("c++", "objective-c") — match the
    // full charset markdown.js's fence parser accepts
    const lang = code && ((code.className || "").match(/lang-([\w+#.-]+)/) || [])[1];
    // the renderer already paints a top-right .code-lang label; the button
    // replaces it (same corner) rather than stacking on top of it
    const langSpan = pre.querySelector && pre.querySelector(".code-lang");
    if (langSpan) langSpan.style.display = "none";
    const btn = el("button", "code-copy", lang ? `${lang} ⧉` : "⧉");
    btn.title = "Copy code";
    btn.onclick = ev => {
      ev.stopPropagation();
      copyText((code || pre).textContent);
      btn.textContent = "✓";
      setTimeout(() => { btn.textContent = lang ? `${lang} ⧉` : "⧉"; }, 1200);
    };
    pre.insertBefore(btn, pre.firstElementChild);
  }
}

// Full-screen image overlay (reference chat ImageLightbox): click an
// attached/response image to zoom, click anywhere to dismiss.
export function openLightbox(src) {
  const ov = el("div", "lightbox");
  const img = document.createElement("img");
  img.src = src;
  ov.appendChild(img);
  ov.onclick = () => ov.remove();
  document.body.appendChild(ov);
  return ov;
}

export function addMessage(role, text, opts) {
  opts = opts || {};
  const welcome = $("welcome-card");
  if (welcome) welcome.remove();  // first real message replaces the empty state
  const wrap = el("div", "msg " + role);
  const roleRow = el("div", "role", role);
  if (opts.timestamp) {
    const d = new Date(opts.timestamp);
    if (!isNaN(d)) roleRow.appendChild(el("span", "ts", d.toLocaleString()));
  }
  wrap.appendChild(roleRow);
  const body = el("div", "body", text || "");
  wrap.appendChild(body);
  const actions = el("div", "actions");
  const copyBtn = el("button", "", "⧉ copy");
  copyBtn.onclick = () => copyText(body.textContent);
  actions.appendChild(copyBtn);
  if (opts.index !== undefined) {
    const delBtn = el("button", "", "✕ delete");
    delBtn.onclick = async () => {
      await deleteMessage(currentSessionId(), opts.index);
      opts.onDelete && opts.onDelete();
    };
    actions.appendChild(delBtn);
  }
  if (role === "user") {
    const reBtn = el("button", "", "↻ resend");
    reBtn.onclick = () => resendMessage(body.textContent);
    actions.appendChild(reBtn);
    // Long pasted messages collapse to a fixed height with an expander
    // (reference MessageItem.tsx USER_MSG_COLLAPSED_PX behavior).
    if ((text || "").length > 1200) {
      body.classList.add("clamped");
      const more = el("button", "expand-btn", "⌄ show more");
      more.onclick = () => {
        const clamped = body.classList.toggle("clamped");
        more.textContent = clamped ? "⌄ show more" : "⌃ show less";
      };
      actions.appendChild(more);
    }
  }
  wrap.appendChild(actions);
  $("messages").appendChild(wrap);
  scrollMessages(true);
  return wrap;
}

// Empty-session welcome card (reference welcome/WelcomePage.tsx): playful
// title/subtitle pools picked once per load, example prompts that fill the
// composer, and project quick-access chips.
const WELCOME_PROMPTS = [
  "What do my loaded modules cover?",
  "/web latest JAX pallas TPU kernel examples",
  "Summarize the uploaded document",
  "/help",
];

export const WELCOME_TITLES = [
  "What would you like to know?",
  "What's on your mind?",
  "Ready when you are",
  "Let's dig in",
  "Go ahead, ask anything",
];

export const WELCOME_SUBTITLES = [
  "Search, ask, and explore your knowledge base",
  "Your documents, one question away",
  "Turn your files into answers",
  "Chat with your data — retrieval runs on TPU",
  "All your knowledge, instantly searchable",
  "The answers are in there somewhere",
  "Your personal research assistant",
];

// Stable across re-renders, random per page load (reference WelcomePage
// initialTitle/initialSubtitle picked at module load time).
const welcomeTitle =
  WELCOME_TITLES[Math.floor(Math.random() * WELCOME_TITLES.length)];
const welcomeSubtitle =
  WELCOME_SUBTITLES[Math.floor(Math.random() * WELCOME_SUBTITLES.length)];

export function renderWelcome() {
  const existing = $("welcome-card");
  if (existing && existing.parentNode) return;  // already shown
  const card = el("div", "welcome");
  card.id = "welcome-card";
  card.appendChild(el("h2", "", welcomeTitle));
  card.appendChild(el("p", "dim", welcomeSubtitle));
  const list = el("div", "welcome-prompts");
  for (const p of WELCOME_PROMPTS) {
    const b = el("button", "hbtn", p);
    b.onclick = () => {
      $("input").value = p;
      $("input").focus();
      $("input").dispatchEvent(new Event("input"));
    };
    list.appendChild(b);
  }
  card.appendChild(list);
  // provider sanity warning (reference WelcomePage "No models available.
  // Check that a provider is running and has models loaded.")
  api("/models").then(r => {
    if ((r.models || []).length) return;
    if (!card.parentNode) return;  // card dismissed meanwhile
    card.appendChild(el("p", "warn-line",
      "No models available. Check that a provider is running and has " +
      "models loaded (Manage → Providers)."));
  }).catch(() => {});
  // project quick access (reference WelcomePage "Your projects" chips)
  const projects = (sessionStore.get().projects || []).slice(0, 5);
  if (projects.length) {
    card.appendChild(el("p", "dim", "Your projects"));
    const chips = el("div", "welcome-prompts");
    for (const pr of projects) {
      const chip = el("button", "hbtn", "🗂 " + pr.name);
      chip.onclick = () => openProjectView(pr.id);
      chips.appendChild(chip);
    }
    card.appendChild(chips);
  }
  $("messages").appendChild(card);
}

// Per-source fetch-status badge (reference WebSearchSources.tsx
// getStatusBadge): success renders nothing — badges flag the exceptions
// (failed / skipped / filtered) the way the reference greys them out.
const STATUS_BADGES = {failed: "failed", skipped: "skipped", filtered: "filtered"};

// Doc-type glyph + per-score confidence level (reference SourceCard
// renderIcon + getConfidenceBadgeVariant thresholds: ≥0.7 high,
// 0.4–0.7 medium, else low).
const TYPE_ICONS = {
  // chunk metadata doc_type uses DocumentType values ("papers"/"library",
  // indexing/metadata.py); SourceType uses "paper"/"library_doc" — both
  // spellings land here depending on the path
  paper: "📄", papers: "📄", book: "📚", web: "🌐", uploaded_pdf: "📑",
  library_doc: "📦", library: "📦",
};

export function scoreConfidence(score) {
  if (score == null) return null;
  return score >= 0.7 ? "high" : score >= 0.4 ? "medium" : "low";
}

// "pdf_544414ce_elms-eye-tracking.pdf" → "elms-eye-tracking.pdf"
// (reference SourceCard filename cleanup: internal doc-id prefixes are
// implementation noise, not something the reader should parse)
export function cleanSourceName(name) {
  return String(name || "").replace(/^(pdf|doc|url|text|arxiv)_[0-9a-f]{6,12}_/, "");
}

export function renderSources(container, sources) {
  if (!sources || !sources.length) return;
  const det = el("details", "sources");
  // status-count summary (reference WebSearchSources.tsx summaryParts):
  // "5 sources · 3 fetched | 1 failed | 1 skipped". Index-retrieval
  // messages carry status="success" on every chunk (SourceNode.to_dict
  // default) — "fetched" is a web-pipeline concept, so the count line
  // appears only when some source did NOT succeed (a real fetch outcome).
  const counts = {};
  for (const s of sources)
    if (s.status) counts[s.status] = (counts[s.status] || 0) + 1;
  const mixed = (counts.failed || 0) + (counts.skipped || 0) +
                (counts.filtered || 0) > 0;
  const bits = [];
  if (mixed) {
    if (counts.success) bits.push(`${counts.success} fetched`);
    if (counts.failed) bits.push(`${counts.failed} failed`);
    if (counts.skipped) bits.push(`${counts.skipped} skipped`);
    if (counts.filtered) bits.push(`${counts.filtered} filtered`);
  }
  det.appendChild(el("summary", "", `${sources.length} sources` +
    (bits.length ? ` · ${bits.join(" | ")}` : "")));
  for (const s of sources) {
    const item = el("div", "source-item");
    const score = el("span", "score", s.score != null ? s.score.toFixed(2) : "—");
    const level = scoreConfidence(s.score);
    if (level) {
      score.classList.add("conf-" + level);
      score.title = {high: "strong match (≥0.70)",
                     medium: "moderate match (0.40–0.70)",
                     low: "weak match (<0.40)"}[level];
      // relevance meter (reference SourceCard score bar): width ∝ score
      const bar = el("span", "score-bar");
      const fill = el("div", "conf-" + level, "");
      fill.style.width = `${Math.round(Math.min(1, Math.max(0, s.score)) * 100)}%`;
      bar.appendChild(fill);
      item.appendChild(bar);
    }
    item.appendChild(score);
    const docType = s.metadata?.doc_type || s.type;
    const icon = TYPE_ICONS[docType];
    if (icon) item.appendChild(el("span", "src-icon", icon + " "));
    const name = cleanSourceName(
      s.metadata?.display_name || s.title || s.metadata?.filename || s.id || "source");
    item.appendChild(document.createTextNode(
      name + (s.metadata?.module ? ` · ${s.metadata.module}` : "")));
    // authors + page metadata line (reference SourceCard metadata rows)
    const meta = [];
    if (s.metadata?.authors) meta.push(String(s.metadata.authors));
    if (s.metadata?.page != null) meta.push(`p. ${s.metadata.page}`);
    if (meta.length) item.appendChild(el("span", "src-meta", " — " + meta.join(" · ")));
    // source-type chip (reference SourceCard type badges): web sources
    // read differently from indexed chunks in a mixed orchestrator answer
    if (s.type && s.type !== "library_doc")
      item.appendChild(el("span", "src-badge type", s.type.replace(/_/g, " ")));
    if (STATUS_BADGES[s.status])
      item.appendChild(el("span", "src-badge " + s.status, STATUS_BADGES[s.status]));
    const srcUrl = s.url && safeUrl(s.url);
    if (srcUrl) {
      const a = el("a", "", " ↗"); a.href = srcUrl; a.target = "_blank"; item.appendChild(a);
    }
    if (s.error) {
      item.appendChild(el("div", "src-error", s.error));
    }
    const body = s.content || s.snippet;  // failed fetches still show their snippet
    if (body) {
      const preview = el("div", "preview", String(body).slice(0, 1500));
      item.appendChild(preview);
      item.onclick = ev => {
        if (ev.target.tagName === "A") return;
        item.classList.toggle("open");
      };
    }
    det.appendChild(item);
  }
  container.appendChild(det);
}

// Full retrieval-metrics display (retrieval/metrics.py schema ≡ reference
// services/retrieval_metrics.py): score distribution, diversity, coverage,
// quality ratios — expandable per message, summary line always visible.
export function renderMetrics(container, metrics, confidence) {
  if (!metrics || !metrics.coverage) return;
  const det = el("details", "metrics");
  const sd = metrics.score_distribution || {};
  const dv = metrics.diversity || {};
  const cv = metrics.coverage || {};
  const ql = metrics.quality || {};
  const sum = el("summary", "",
    `chunks ${cv.total_chunks} · ~${cv.estimated_tokens} tok · best ${(sd.max ?? 0).toFixed?.(2) ?? "—"}`);
  if (confidence) {
    const cls = confidence === "normal" ? "normal" : confidence === "low" ? "low" : "none";
    sum.appendChild(el("span", "conf-badge " + cls, confidence));
  }
  det.appendChild(sum);
  const grid = el("div", "mgrid");
  const put = (k, v, tip) => {
    const d = el("div", "", k + " ");
    const b = el("b", "", v == null ? "—" : String(v));
    d.appendChild(b);
    if (tip) { d.title = tip; d.classList.add("has-tip"); }
    grid.appendChild(d);
  };
  const f2 = x => x == null ? null : (+x).toFixed(2);
  // Per-metric interpretation tooltips (reference SourceCard
  // getMedianTooltip/getIQRTooltip/… reduced to their guidance line).
  put("score mean", f2(sd.mean),
      "Average source relevance; below ~0.4 means the corpus barely covers this query.");
  put("median", f2(sd.median),
      "Middle relevance score — half the sources score above, half below.");
  put("min", f2(sd.min)); put("max", f2(sd.max));
  put("std", f2(sd.std),
      "Score spread: low = uniform quality, high = a few strong hits over noise.");
  put("unique sources", dv.unique_sources,
      "Distinct documents behind the chunks — breadth of evidence.");
  put("doc types", dv.unique_doc_types,
      "Distinct source kinds (papers, docs, web) contributing context.");
  put("entropy", f2(dv.source_entropy),
      "How evenly chunks spread across documents: 0 = one doc dominates.");
  put("chunks", cv.total_chunks,
      "Passages retrieved for context — more is broader but slower.");
  put("chars", cv.total_chars);
  put("est tokens", cv.estimated_tokens,
      "Approximate context budget these sources consume.");
  put("high-score ratio", f2(ql.high_score_ratio),
      "Fraction scoring ≥0.7 — strong matches.");
  put("low-score ratio", f2(ql.low_score_ratio),
      "Fraction scoring <0.4 — noise; high values suggest narrowing the query.");
  det.appendChild(grid);
  container.appendChild(det);
}

// Per-message tool-call timeline: accumulated from tool_progress events
// during streaming (reference MessageToolSteps display).
// Post-stream generation stats (reference ResponseStats on MessageItem):
// token estimate, wall time, throughput from the done message.
export function renderStats(container, stats) {
  if (!stats || !stats.est_tokens) return;
  const bits = [`≈${stats.est_tokens} tok`];
  if (stats.duration_ms != null) bits.push(`${(stats.duration_ms / 1000).toFixed(1)} s`);
  if (stats.tokens_per_s != null) bits.push(`${stats.tokens_per_s} tok/s`);
  container.appendChild(el("div", "gen-stats", bits.join(" · ")));
}

// Persisted-history tool steps: same timeline renderer as the live stream
// (chat/progress.js), collapsed with completed/failed counts.
export function renderToolSteps(container, steps) {
  if (!steps || !steps.length) return;
  renderToolTimeline(container, steps, {live: false});
}

export function renderThinking(container, text, opts) {
  // opts.before: insert ahead of that node (live streaming places the block
  // above the message body); opts.open: start expanded. Used by both the
  // session-reload path and ws.js's live thinking handler — one DOM shape.
  opts = opts || {};
  if (!text && !opts.open) return null;
  const det = el("details", "thinking");
  det.appendChild(el("summary", "", "thinking"));
  det.appendChild(el("div", "tbody", text || ""));
  if (opts.open) det.open = true;
  if (opts.before) container.insertBefore(det, opts.before);
  else container.appendChild(det);
  return det;
}
