// Safe markdown renderer: block-level parser + inline markup + TeX math +
// syntax-highlighted code, with the same security contract as before —
// escape first, re-introduce markup, and only http(s)/same-origin-relative
// URLs may reach href/src (LLM output synthesized over fetched web content
// is untrusted; javascript:/data: URIs and attribute breakouts must never
// execute — stored XSS via session history).
//
// Covers the rendering surface of the reference's MemoizedMarkdown.tsx
// (react-markdown + remark-gfm + rehype-katex + rehype-highlight,
// reference frontend/package.json:37,48-49): headings, paragraphs, ordered/
// unordered/nested/task lists, blockquotes, pipe tables, hr, fenced code
// with language highlighting, inline code, bold/italic/strikethrough,
// links/images, and $…$/$$…$$/\(…\)/\[…\] math via the vendored tex.js.

import { renderTex } from "./tex.js";
import { highlight } from "./highlight.js";

export function escapeHtml(s) {
  return s.replace(/&/g, "&amp;").replace(/</g, "&lt;").replace(/>/g, "&gt;")
    .replace(/"/g, "&quot;").replace(/'/g, "&#39;");
}

export function safeUrl(u) {
  u = u.trim();
  if (/^https?:\/\//i.test(u)) return u;
  if (/^\/(?!\/)/.test(u)) return u; // relative, e.g. /api/sessions/.../images/x
  return null;
}

// ------------------------------------------------------------- inline pass

function renderInline(text) {
  let s = escapeHtml(text);
  s = s
    .replace(/!\[([^\]]*)\]\(([^)\s]+)(?:\s+[^)]*)?\)/g, (m, alt, url) => {
      const u = safeUrl(url);
      return u ? `<img src="${u}" alt="${alt}" style="max-width:100%;border-radius:8px">` : m;
    })
    .replace(/\[([^\]]+)\]\(([^)\s]+)(?:\s+[^)]*)?\)/g, (m, label, url) => {
      const u = safeUrl(url);
      return u ? `<a href="${u}" target="_blank" rel="noopener">${label}</a>` : m;
    })
    .replace(/\*\*\*([^*]+)\*\*\*/g, "<strong><em>$1</em></strong>")
    .replace(/\*\*([^*]+)\*\*/g, "<strong>$1</strong>")
    .replace(/(^|[^\w*])\*([^*\n]+)\*(?![\w*])/g, "$1<em>$2</em>")
    .replace(/(^|[^\w])_([^_\n]+)_(?![\w])/g, "$1<em>$2</em>")
    .replace(/~~([^~\n]+)~~/g, "<del>$1</del>");
  return s;
}

// -------------------------------------------------------------- lists

function collectListItems(lines, i) {
  // Gather contiguous list-item lines plus their indented continuations.
  const items = [];
  while (i < lines.length) {
    const m = /^(\s*)([-*+]|\d+[.)])\s+(.*)$/.exec(lines[i]);
    if (m) {
      items.push({ indent: m[1].length, ordered: /^\d/.test(m[2]), lines: [m[3]] });
      i++;
    } else if (/^\s*$/.test(lines[i])) {
      // blank line ends the list unless the next line is still list material
      if (i + 1 < lines.length &&
          (/^(\s*)([-*+]|\d+[.)])\s+/.test(lines[i + 1]) || /^\s{2,}\S/.test(lines[i + 1]))) i++;
      else break;
    } else if (items.length && /^\s{2,}\S/.test(lines[i])) {
      items[items.length - 1].lines.push(lines[i].replace(/^\s{1,4}/, ""));
      i++;
    } else break;
  }
  return { items, i };
}

function buildList(items, i, level) {
  const ordered = items[i].ordered;
  let html = ordered ? "<ol>" : "<ul>";
  while (i < items.length && items[i].indent >= level) {
    if (items[i].indent > level) {
      // deeper item with no parent at this level: nest under previous li
      const r = buildList(items, i, items[i].indent);
      html = html.endsWith("</li>")
        ? html.slice(0, -5) + r.html + "</li>"
        : html + `<li>${r.html}</li>`;
      i = r.i;
      continue;
    }
    let body = items[i].lines.join("\n");
    let cls = "";
    const task = /^\[([ xX])\]\s+([\s\S]*)$/.exec(body);
    if (task) {
      const on = task[1] !== " ";
      body = task[2];
      cls = ' class="task"';
      body = `<input type="checkbox" disabled${on ? " checked" : ""}> ` + renderInline(body).replace(/\n/g, "<br>");
    } else {
      body = renderInline(body).replace(/\n/g, "<br>");
    }
    html += `<li${cls}>${body}`;
    i++;
    if (i < items.length && items[i].indent > level) {
      const r = buildList(items, i, items[i].indent);
      html += r.html;
      i = r.i;
    }
    html += "</li>";
  }
  return { html: html + (ordered ? "</ol>" : "</ul>"), i };
}

// -------------------------------------------------------------- tables

function renderTable(lines, i) {
  const rows = [];
  while (i < lines.length && /^\s*\|.*\|\s*$/.test(lines[i])) {
    rows.push(lines[i].trim());
    i++;
  }
  const cells = line => line.replace(/^\||\|$/g, "").split("|").map(c => renderInline(c.trim()));
  const head = cells(rows[0]);
  const body = rows.slice(2).map(cells);
  const html = "<table><thead><tr>" + head.map(h => `<th>${h}</th>`).join("") +
    "</tr></thead><tbody>" +
    body.map(r => "<tr>" + r.map(c => `<td>${c}</td>`).join("") + "</tr>").join("") +
    "</tbody></table>";
  return { html, i };
}

// -------------------------------------------------------------- blocks

const BLOCK_START = /^(\s*)(#{1,6}\s|>|[-*+]\s|\d+[.)]\s|\|)/;

function parseBlocks(text) {
  const lines = text.split("\n");
  let html = "", i = 0;
  while (i < lines.length) {
    const line = lines[i];
    if (/^\s*$/.test(line)) { i++; continue; }
    // a line that is only extraction placeholders (code block / display math)
    if (/^\s*(?:\u0000MD\d+\u0000\s*)+$/.test(line)) { html += line.trim(); i++; continue; }
    let m = /^(#{1,6})\s+(.*?)\s*#*\s*$/.exec(line);
    if (m) { html += `<h${m[1].length}>${renderInline(m[2])}</h${m[1].length}>`; i++; continue; }
    if (/^\s*((-\s*){3,}|(\*\s*){3,}|(_\s*){3,})$/.test(line)) { html += "<hr>"; i++; continue; }
    if (/^\s*>/.test(line)) {
      const buf = [];
      while (i < lines.length && (/^\s*>/.test(lines[i]) || (buf.length && /\S/.test(lines[i]) && !BLOCK_START.test(lines[i])))) {
        buf.push(lines[i].replace(/^\s*> ?/, ""));
        i++;
      }
      html += `<blockquote>${parseBlocks(buf.join("\n"))}</blockquote>`;
      continue;
    }
    if (/^\s*\|.*\|\s*$/.test(line) && i + 1 < lines.length && /^\s*\|[\s:|-]+\|\s*$/.test(lines[i + 1])) {
      const r = renderTable(lines, i);
      html += r.html;
      i = r.i;
      continue;
    }
    if (/^(\s*)([-*+]|\d+[.)])\s+/.test(line)) {
      const c = collectListItems(lines, i);
      if (c.items.length) {
        html += buildList(c.items, 0, c.items[0].indent).html;
        i = c.i;
        continue;
      }
    }
    // paragraph: absorb until blank line or a block opener
    const buf = [line];
    i++;
    while (i < lines.length && /\S/.test(lines[i]) && !BLOCK_START.test(lines[i]) &&
           !/^\s*(?:\u0000MD\d+\u0000\s*)+$/.test(lines[i])) {
      buf.push(lines[i]);
      i++;
    }
    html += `<p>${renderInline(buf.join("\n")).replace(/\n/g, "<br>")}</p>`;
  }
  return html;
}

// -------------------------------------------------------------- extraction

function codeBlock(lang, code) {
  const label = lang ? `<span class="code-lang">${escapeHtml(lang)}</span>` : "";
  return `<pre>${label}<code class="lang-${escapeHtml(lang || "text")}">${highlight(code.replace(/\n$/, ""), lang)}</code></pre>`;
}

// Inline math: opening $ not followed by whitespace, closing $ not preceded
// by whitespace and not followed by a digit (so "$5 and $10" stays text).
const INLINE_MATH = /\$([^\s$](?:[^$\n]*[^\s$])?)\$(?!\d)/g;

export function renderMarkdown(src) {
  const slots = [];
  const put = html => { slots.push(html); return "\u0000MD" + (slots.length - 1) + "\u0000"; };

  // extraction order matters: fenced code shields everything inside it,
  // inline code shields $ and markup, then math before any escaping.
  src = src.replace(/```([\w+#.-]*)[^\S\n]*\n?([\s\S]*?)(?:```|$)/g, (m, lang, code) => put(codeBlock(lang, code)));
  src = src.replace(/`([^`\n]+)`/g, (m, code) => put(`<code>${escapeHtml(code)}</code>`));
  src = src.replace(/\$\$([\s\S]+?)\$\$/g, (m, tex) => put(renderTex(tex.trim(), true)));
  src = src.replace(/\\\[([\s\S]+?)\\\]/g, (m, tex) => put(renderTex(tex.trim(), true)));
  src = src.replace(/\\\(([\s\S]+?)\\\)/g, (m, tex) => put(renderTex(tex.trim(), false)));
  src = src.replace(INLINE_MATH, (m, tex, off, whole) => {
    if (whole[off - 1] === "\\" || whole[off - 1] === "$") return m; // \$ escape / $$ leftovers
    return put(renderTex(tex, false));
  });

  let html = parseBlocks(src);
  // placeholders may nest (math inside a table cell inside a blockquote);
  // resolve until fixed point, bounded for safety.
  for (let pass = 0; pass < 8 && html.indexOf("\u0000") !== -1; pass++) {
    html = html.replace(/\u0000MD(\d+)\u0000/g, (_, n) => slots[+n]);
  }
  return html;
}
