// Memoized streaming markdown (reference MemoizedMarkdown.tsx: marked.lexer
// splits the streamed text into blocks, each block is a memoized component,
// so a new token only re-renders the open tail block). Same idea without
// React: the stream is append-only, so every block except the last is
// final — render it once, key its HTML by the block's text, and on each
// repaint only the changed tail block pays a parse. Repaint cost is
// O(open block), not O(whole message) — on a long answer the difference is
// the whole message re-parsing 8×/s during streaming.
//
// The block split must never cut INSIDE a fenced code block or display
// math: renderMarkdown's extraction pass (lib/markdown.js) needs the
// closing fence/``$$`` in the same string as the opener. Unterminated
// fences (mid-stream) stay in the open tail block until they close.
//
// The final `done` repaint renders the full text in one call (ws.js), so
// any seam artifact of per-block rendering (a list whose items are split
// by blank lines becoming two adjacent lists mid-stream) is transient.

import {renderMarkdown} from "./markdown.js";

export function splitBlocks(src) {
  const blocks = [];
  let cur = [];
  let fence = false;   // inside ``` ... ```
  let math = false;    // inside $$ ... $$ spanning lines
  for (const line of src.split("\n")) {
    if (!math && /^\s*```/.test(line)) fence = !fence;
    else if (!fence) {
      const dollars = (line.match(/\$\$/g) || []).length;
      if (dollars % 2 === 1) math = !math;
    }
    if (!fence && !math && /^\s*$/.test(line)) {
      if (cur.length) { blocks.push(cur.join("\n")); cur = []; }
      continue;
    }
    cur.push(line);
  }
  if (cur.length) blocks.push(cur.join("\n"));
  return blocks;
}

// Returns repaint(raw): reconciles `container`'s children (one div per
// block) against splitBlocks(raw), re-rendering only blocks whose text
// changed — for an append-only stream, just the open tail.
export function createStreamRenderer(container) {
  const rendered = [];  // block text whose HTML is already in child i
  return function repaint(raw) {
    const blocks = splitBlocks(raw);
    for (let i = 0; i < blocks.length; i++) {
      let node = container.children[i];
      if (!node) {
        node = document.createElement("div");
        node.className = "md-block";
        container.appendChild(node);
      }
      if (rendered[i] !== blocks[i]) {
        node.innerHTML = renderMarkdown(blocks[i]);
        rendered[i] = blocks[i];
      }
    }
    while (container.children.length > blocks.length) {
      container.lastChild.remove();  // raw shrank (stop/edit) — drop stale tails
      rendered.pop();
    }
    rendered.length = blocks.length;
  };
}
