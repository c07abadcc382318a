// Self-contained TeX-subset → HTML math renderer (no fonts, no deps).
// Replaces the reference's katex + rehype-katex stack
// (reference: frontend/package.json:37,48-49, rendered in
// frontend/src/components/chat/MemoizedMarkdown.tsx) with a vendored
// renderer sized for the constructs that actually appear in ML/math
// papers: fractions, scripts, radicals, big operators with limits,
// decorated letters (mathbb/cal/frak/bf), accents, matrices/cases/aligned
// environments, stretchy delimiters, text mode and spacing.
//
// Output is plain nested <span>s styled by .tex-* classes in app.css.
// All literal text passes through esc() — TeX inside an LLM answer is
// untrusted content and must never break out into markup.

function esc(s) {
  return String(s).replace(/&/g, "&amp;").replace(/</g, "&lt;").replace(/>/g, "&gt;")
    .replace(/"/g, "&quot;").replace(/'/g, "&#39;");
}

// ---------------------------------------------------------------- symbols

const GREEK = {
  alpha: "α", beta: "β", gamma: "γ", delta: "δ", epsilon: "ϵ", varepsilon: "ε",
  zeta: "ζ", eta: "η", theta: "θ", vartheta: "ϑ", iota: "ι", kappa: "κ",
  lambda: "λ", mu: "μ", nu: "ν", xi: "ξ", pi: "π", varpi: "ϖ", rho: "ρ",
  varrho: "ϱ", sigma: "σ", varsigma: "ς", tau: "τ", upsilon: "υ", phi: "ϕ",
  varphi: "φ", chi: "χ", psi: "ψ", omega: "ω",
  Gamma: "Γ", Delta: "Δ", Theta: "Θ", Lambda: "Λ", Xi: "Ξ", Pi: "Π",
  Sigma: "Σ", Upsilon: "Υ", Phi: "Φ", Psi: "Ψ", Omega: "Ω",
};

const SYMS = {
  infty: "∞", partial: "∂", nabla: "∇", pm: "±", mp: "∓", times: "×",
  cdot: "⋅", div: "÷", ast: "∗", star: "⋆", bullet: "∙", circ: "∘",
  oplus: "⊕", ominus: "⊖", otimes: "⊗", oslash: "⊘", odot: "⊙",
  leq: "≤", le: "≤", geq: "≥", ge: "≥", neq: "≠", ne: "≠", approx: "≈",
  equiv: "≡", sim: "∼", simeq: "≃", cong: "≅", propto: "∝", ll: "≪", gg: "≫",
  prec: "≺", succ: "≻", preceq: "⪯", succeq: "⪰", asymp: "≍", doteq: "≐",
  in: "∈", notin: "∉", ni: "∋", subset: "⊂", supset: "⊃", subseteq: "⊆",
  supseteq: "⊇", sqsubseteq: "⊑", sqsupseteq: "⊒", cup: "∪", cap: "∩",
  sqcup: "⊔", sqcap: "⊓", setminus: "∖", uplus: "⊎",
  wedge: "∧", land: "∧", vee: "∨", lor: "∨", neg: "¬", lnot: "¬",
  forall: "∀", exists: "∃", nexists: "∄", emptyset: "∅", varnothing: "∅",
  top: "⊤", bot: "⊥", vdash: "⊢", dashv: "⊣", models: "⊨", perp: "⊥",
  parallel: "∥", mid: "∣", nmid: "∤", angle: "∠", triangle: "△",
  rightarrow: "→", to: "→", leftarrow: "←", gets: "←", leftrightarrow: "↔",
  Rightarrow: "⇒", implies: "⇒", Leftarrow: "⇐", Leftrightarrow: "⇔",
  iff: "⇔", mapsto: "↦", longrightarrow: "⟶", longleftarrow: "⟵",
  Longrightarrow: "⟹", Longleftarrow: "⟸", longmapsto: "⟼",
  uparrow: "↑", downarrow: "↓", updownarrow: "↕", Uparrow: "⇑", Downarrow: "⇓",
  nearrow: "↗", searrow: "↘", swarrow: "↙", nwarrow: "↖",
  hookrightarrow: "↪", hookleftarrow: "↩", rightharpoonup: "⇀",
  dots: "…", ldots: "…", cdots: "⋯", vdots: "⋮", ddots: "⋱",
  prime: "′", hbar: "ℏ", ell: "ℓ", Re: "ℜ", Im: "ℑ", aleph: "ℵ", wp: "℘",
  imath: "ı", jmath: "ȷ", dagger: "†", ddagger: "‡", S: "§", P: "¶",
  copyright: "©", pounds: "£", checkmark: "✓",
  langle: "⟨", rangle: "⟩", lceil: "⌈", rceil: "⌉", lfloor: "⌊", rfloor: "⌋",
  lvert: "|", rvert: "|", lVert: "‖", rVert: "‖", Vert: "‖", vert: "|",
  backslash: "\\", lbrace: "{", rbrace: "}", lbrack: "[", rbrack: "]",
  surd: "√", degree: "°", flat: "♭", sharp: "♯", natural: "♮",
  therefore: "∴", because: "∵", coloneqq: "≔", triangleq: "≜",
};

// \sin … rendered upright; limits-style big operators take under/over in display.
const FUNCS = ["sin", "cos", "tan", "cot", "sec", "csc", "arcsin", "arccos",
  "arctan", "sinh", "cosh", "tanh", "coth", "log", "ln", "lg", "exp", "det",
  "dim", "ker", "deg", "gcd", "hom", "arg", "Pr", "tr", "rank", "sgn"];
const BIGOPS = {
  sum: "∑", prod: "∏", coprod: "∐", int: "∫", oint: "∮", iint: "∬",
  iiint: "∭", bigcup: "⋃", bigcap: "⋂", bigoplus: "⨁", bigotimes: "⨂",
  bigodot: "⨀", bigvee: "⋁", bigwedge: "⋀", bigsqcup: "⨆",
};
const LIMFUNCS = ["lim", "limsup", "liminf", "max", "min", "sup", "inf",
  "argmax", "argmin"];

// Decorated alphabets via Unicode Mathematical Alphanumeric Symbols.
// Each entry: [A-Z base, a-z base, 0-9 base or null, exceptions map].
const ALPHABETS = {
  mathbb: [0x1d538, 0x1d552, 0x1d7d8, { C: "ℂ", H: "ℍ", N: "ℕ", P: "ℙ", Q: "ℚ", R: "ℝ", Z: "ℤ" }],
  mathcal: [0x1d49c, 0x1d4b6, null, { B: "ℬ", E: "ℰ", F: "ℱ", H: "ℋ", I: "ℐ", L: "ℒ", M: "ℳ", R: "ℛ", e: "ℯ", g: "ℊ", o: "ℴ" }],
  mathfrak: [0x1d504, 0x1d51e, null, { C: "ℭ", H: "ℌ", I: "ℑ", R: "ℜ", Z: "ℨ" }],
  mathscr: [0x1d49c, 0x1d4b6, null, { B: "ℬ", E: "ℰ", F: "ℱ", H: "ℋ", I: "ℐ", L: "ℒ", M: "ℳ", R: "ℛ", e: "ℯ", g: "ℊ", o: "ℴ" }],
};

function mapAlphabet(kind, text) {
  const [up, lo, dig, exc] = ALPHABETS[kind];
  let out = "";
  for (const ch of text) {
    if (exc && exc[ch]) out += exc[ch];
    else if (ch >= "A" && ch <= "Z") out += String.fromCodePoint(up + ch.charCodeAt(0) - 65);
    else if (ch >= "a" && ch <= "z") out += String.fromCodePoint(lo + ch.charCodeAt(0) - 97);
    else if (dig && ch >= "0" && ch <= "9") out += String.fromCodePoint(dig + ch.charCodeAt(0) - 48);
    else out += ch;
  }
  return out;
}

const ACCENTS = {
  hat: "̂", widehat: "̂", bar: "̄", overline: null,
  vec: "⃗", tilde: "̃", widetilde: "̃", dot: "̇",
  ddot: "̈", check: "̌", breve: "̆", acute: "́",
  grave: "̀", mathring: "̊",
};

const SPACES = { ",": " ", ":": " ", ";": " ", "!": "", " ": " ", quad: " ", qquad: "  ", enspace: " " };

// ---------------------------------------------------------------- tokenizer

function tokenize(tex) {
  const toks = [];
  let i = 0;
  while (i < tex.length) {
    const c = tex[i];
    if (c === "\\") {
      const m = /^\\([a-zA-Z]+)\s*/.exec(tex.slice(i));
      if (m) { toks.push({ t: "cs", v: m[1] }); i += m[0].length; }
      else { toks.push({ t: "cs", v: tex[i + 1] || "" }); i += 2; }
    } else if (c === "{") { toks.push({ t: "{" }); i++; }
    else if (c === "}") { toks.push({ t: "}" }); i++; }
    else if (c === "^" || c === "_" || c === "&") { toks.push({ t: c }); i++; }
    else if (/\s/.test(c)) { i++; } // math mode: whitespace is not significant
    else { toks.push({ t: "ch", v: c }); i++; }
  }
  return toks;
}

// ---------------------------------------------------------------- parser

// Node kinds: {k:'ord',v}, {k:'op',v,limits}, {k:'frac',num,den}, {k:'sqrt',idx,body},
// {k:'scripts',base,sup,sub}, {k:'group',body}, {k:'style',cls,body},
// {k:'str',v,cls}, {k:'accent',ch,body}, {k:'ov'|'un',body}, {k:'env',name,rows},
// {k:'delim',left,right,body}, {k:'space',v}, {k:'bin'|'rel',v}

class Parser {
  constructor(toks) { this.toks = toks; this.p = 0; }
  peek() { return this.toks[this.p]; }
  next() { return this.toks[this.p++]; }
  done() { return this.p >= this.toks.length; }

  // Parse a balanced {…} group or single atom (TeX argument rules).
  parseArg() {
    const tk = this.peek();
    if (!tk) return { k: "group", body: [] };
    if (tk.t === "{") { this.next(); return { k: "group", body: this.parseList("}") }; }
    const atom = this.parseAtom();
    return atom || { k: "group", body: [] };
  }

  // Optional [..] argument (e.g. \sqrt[3]{x}).
  parseOpt() {
    const tk = this.peek();
    if (tk && tk.t === "ch" && tk.v === "[") {
      this.next();
      const body = [];
      while (!this.done()) {
        const t = this.peek();
        if (t.t === "ch" && t.v === "]") { this.next(); break; }
        const a = this.parseAtom();
        if (a) body.push(a); else this.next();
      }
      return { k: "group", body };
    }
    return null;
  }

  parseList(closer, stopCs) {
    const out = [];
    while (!this.done()) {
      const tk = this.peek();
      if (closer && tk.t === closer) { this.next(); break; }
      if (stopCs && tk.t === "cs" && stopCs.includes(tk.v)) break;
      if (tk.t === "&" || (tk.t === "cs" && tk.v === "\\")) break; // row/cell break handled by env parser
      const atom = this.parseAtomWithScripts();
      if (atom) out.push(atom);
      else this.next(); // unknown: skip
    }
    return out;
  }

  parseAtomWithScripts() {
    let base = this.parseAtom();
    if (!base) return null;
    let sup = null, sub = null;
    while (!this.done()) {
      const tk = this.peek();
      if (tk.t === "^") { this.next(); sup = this.parseArg(); }
      else if (tk.t === "_") { this.next(); sub = this.parseArg(); }
      else if (tk.t === "ch" && tk.v === "'") {
        this.next();
        let primes = "′";
        while (this.peek() && this.peek().t === "ch" && this.peek().v === "'") { this.next(); primes += "′"; }
        sup = sup ? { k: "group", body: [sup, { k: "ord", v: primes }] } : { k: "ord", v: primes };
      } else break;
    }
    if (sup || sub) return { k: "scripts", base, sup, sub };
    return base;
  }

  parseAtom() {
    const tk = this.peek();
    if (!tk) return null;
    if (tk.t === "{") { this.next(); return { k: "group", body: this.parseList("}") }; }
    if (tk.t === "}") return null;
    if (tk.t === "ch") {
      this.next();
      const c = tk.v;
      if (/[0-9.]/.test(c)) {
        // glue digit runs so "123" isn't three italic atoms
        let num = c;
        while (this.peek() && this.peek().t === "ch" && /[0-9.]/.test(this.peek().v)) num += this.next().v;
        return { k: "str", v: num, cls: "tex-mn" };
      }
      if (/[a-zA-Z]/.test(c)) return { k: "ord", v: c };
      if ("+−-*/=<>".includes(c)) return { k: "bin", v: c === "-" ? "−" : c };
      if (",;:!?()[]|".includes(c)) return { k: "str", v: c, cls: "tex-mo" };
      return { k: "str", v: c, cls: "" };
    }
    if (tk.t === "cs") return this.parseCommand();
    return null;
  }

  parseCommand() {
    const tk = this.next();
    const name = tk.v;
    if (GREEK[name]) return { k: "ord", v: GREEK[name] };
    if (SYMS[name]) {
      const rel = /arrow|Arrow|leq|geq|neq|equiv|approx|sim|in$|subset|supset|models|vdash|mapsto|to$|propto|cong|prec|succ|iff|implies/.test(name);
      return { k: rel ? "rel" : "str", v: SYMS[name], cls: rel ? "" : "tex-mo" };
    }
    if (BIGOPS[name]) return { k: "op", v: BIGOPS[name], limits: name !== "int" && name !== "oint" && name !== "iint" && name !== "iiint" };
    if (FUNCS.includes(name)) return { k: "str", v: name, cls: "tex-fn" };
    if (LIMFUNCS.includes(name)) {
      const disp = { argmax: "arg max", argmin: "arg min", limsup: "lim sup", liminf: "lim inf" }[name] || name;
      return { k: "op", v: disp, limits: true, fn: true };
    }
    if (SPACES[name] !== undefined) return { k: "space", v: SPACES[name] };
    if (ACCENTS[name] !== undefined) {
      const body = this.parseArg();
      if (name === "overline") return { k: "ov", body };
      return { k: "accent", ch: ACCENTS[name], body };
    }
    switch (name) {
      case "frac": case "dfrac": case "tfrac": case "cfrac":
        return { k: "frac", num: this.parseArg(), den: this.parseArg() };
      case "binom": case "dbinom": case "tbinom": {
        const a = this.parseArg(), b = this.parseArg();
        return { k: "delim", left: "(", right: ")", body: [{ k: "frac", num: a, den: b, noline: true }] };
      }
      case "sqrt": {
        const idx = this.parseOpt();
        return { k: "sqrt", idx, body: this.parseArg() };
      }
      case "text": case "textrm": case "textnormal": case "mbox": case "textit": case "textbf": case "texttt": {
        const cls = name === "textit" ? "tex-textit" : name === "textbf" ? "tex-textbf" : name === "texttt" ? "tex-tt" : "tex-text";
        return { k: "str", v: this.readRawGroup(), cls };
      }
      case "operatorname": return { k: "str", v: this.readRawGroup(), cls: "tex-fn" };
      case "mathrm": return { k: "style", cls: "tex-rm", body: this.parseArg() };
      case "mathbf": case "boldsymbol": case "bm": return { k: "style", cls: "tex-bf", body: this.parseArg() };
      case "mathit": return { k: "style", cls: "tex-it", body: this.parseArg() };
      case "mathsf": return { k: "style", cls: "tex-sf", body: this.parseArg() };
      case "mathtt": return { k: "style", cls: "tex-tt", body: this.parseArg() };
      case "mathbb": case "mathcal": case "mathfrak": case "mathscr": {
        const raw = this.readRawGroup();
        return { k: "str", v: mapAlphabet(name, raw), cls: "tex-rm" };
      }
      case "underline": return { k: "un", body: this.parseArg() };
      case "overbrace": return { k: "ov", body: this.parseArg(), brace: "⏞" };
      case "underbrace": return { k: "un", body: this.parseArg(), brace: "⏟" };
      case "overrightarrow": return { k: "ov", body: this.parseArg(), brace: "→" };
      case "stackrel": case "overset": {
        const over = this.parseArg(), base = this.parseArg();
        return { k: "scripts", base, sup: over, sub: null, over: true };
      }
      case "underset": {
        const under = this.parseArg(), base = this.parseArg();
        return { k: "scripts", base, sup: null, sub: under, over: true };
      }
      case "left": return this.parseDelim();
      case "right": return null; // unbalanced \right — parseDelim consumes matched ones
      case "big": case "Big": case "bigg": case "Bigg":
      case "bigl": case "Bigl": case "biggl": case "Biggl":
      case "bigr": case "Bigr": case "biggr": case "Biggr": {
        const d = this.next();
        const ch = d ? (d.t === "cs" ? (SYMS[d.v] || "") : d.v) : "";
        return { k: "str", v: ch, cls: "tex-bigdelim" };
      }
      case "begin": return this.parseEnv();
      case "end": { this.readRawGroup(); return null; }
      case "displaystyle": case "textstyle": case "scriptstyle": case "limits": case "nolimits":
        return { k: "space", v: "" };
      case "label": case "tag": case "notag": case "nonumber": {
        if (this.peek() && this.peek().t === "{") this.readRawGroup();
        return { k: "space", v: "" };
      }
      case "phantom": case "hphantom": case "vphantom":
        return { k: "style", cls: "tex-phantom", body: this.parseArg() };
      case "not": {
        const a = this.parseArg();
        return { k: "group", body: [a, { k: "str", v: "̸", cls: "" }] };
      }
      default:
        if (name.length === 1 && !/[a-zA-Z]/.test(name)) {
          // escaped literal: \{ \} \% \$ \# \& \_
          return { k: "str", v: name, cls: "tex-mo" };
        }
        // unknown command: render its name upright so nothing is silently eaten
        return { k: "str", v: name, cls: "tex-unknown" };
    }
  }

  // read a {..} group as raw text (for \text, \operatorname, alphabet mapping)
  readRawGroup() {
    const tk = this.peek();
    if (!tk) return "";
    if (tk.t !== "{") { this.next(); return tk.v || ""; }
    this.next();
    let depth = 1, out = "";
    while (!this.done()) {
      const t = this.next();
      if (t.t === "{") { depth++; out += "{"; }
      else if (t.t === "}") { depth--; if (!depth) break; out += "}"; }
      else if (t.t === "cs") out += "\\" + t.v + (t.v.length > 1 ? " " : "");
      else if (t.t === "ch") out += t.v;
      else out += t.t;
    }
    return out;
  }

  parseDelim() {
    const open = this.next();
    const left = open ? (open.t === "cs" ? (SYMS[open.v] || (open.v === "." ? "" : open.v)) : (open.v === "." ? "" : open.v)) : "";
    const body = [];
    let right = "";
    let depth = 0;
    while (!this.done()) {
      const tk = this.peek();
      if (tk.t === "cs" && tk.v === "left") depth++;
      if (tk.t === "cs" && tk.v === "right") {
        if (depth === 0) {
          this.next();
          const close = this.next();
          right = close ? (close.t === "cs" ? (SYMS[close.v] || (close.v === "." ? "" : close.v)) : (close.v === "." ? "" : close.v)) : "";
          break;
        }
        depth--;
      }
      const atom = this.parseAtomWithScripts();
      if (atom) body.push(atom);
      else if (!this.done() && !(this.peek().t === "cs" && this.peek().v === "right")) this.next();
    }
    return { k: "delim", left, right, body };
  }

  parseEnv() {
    const name = this.readRawGroup().replace(/\*$/, "");
    const rows = [[[]]]; // rows → cells → atoms
    while (!this.done()) {
      const tk = this.peek();
      if (tk.t === "cs" && tk.v === "end") { this.next(); this.readRawGroup(); break; }
      if (tk.t === "cs" && tk.v === "\\") { this.next(); rows.push([[]]); continue; }
      if (tk.t === "&") { this.next(); rows[rows.length - 1].push([]); continue; }
      const atom = this.parseAtomWithScripts();
      if (atom) rows[rows.length - 1][rows[rows.length - 1].length - 1].push(atom);
      else this.next();
    }
    // drop trailing empty row produced by a final \\
    if (rows.length > 1) {
      const last = rows[rows.length - 1];
      if (last.length === 1 && last[0].length === 0) rows.pop();
    }
    return { k: "env", name, rows };
  }
}

// ---------------------------------------------------------------- renderer

function renderList(nodes, display) {
  return nodes.map(n => renderNode(n, display)).join("");
}

function renderNode(n, display) {
  if (!n) return "";
  switch (n.k) {
    case "ord": return `<span class="tex-mi">${esc(n.v)}</span>`;
    case "str": return `<span class="${n.cls || "tex-mo"}">${esc(n.v)}</span>`;
    case "bin": return `<span class="tex-bin">${esc(n.v)}</span>`;
    case "rel": return `<span class="tex-rel">${esc(n.v)}</span>`;
    case "space": return n.v ? `<span class="tex-sp">${esc(n.v)}</span>` : "";
    case "group": return renderList(n.body, display);
    case "style": return `<span class="${n.cls}">${renderNode(n.body, display)}</span>`;
    case "op": {
      const cls = n.fn ? "tex-fn" : "tex-bigop";
      return `<span class="${cls}${display && n.limits ? " tex-limits" : ""}">${esc(n.v)}</span>`;
    }
    case "frac": {
      const line = n.noline ? " tex-noline" : "";
      return `<span class="tex-frac"><span class="tex-num">${renderList(n.num.k === "group" ? n.num.body : [n.num], false)}</span>` +
        `<span class="tex-den${line}">${renderList(n.den.k === "group" ? n.den.body : [n.den], false)}</span></span>`;
    }
    case "sqrt": {
      const idx = n.idx ? `<span class="tex-rootidx">${renderList(n.idx.body, false)}</span>` : "";
      return `<span class="tex-sqrt">${idx}<span class="tex-surd">√</span><span class="tex-radicand">${renderNode(n.body, display)}</span></span>`;
    }
    case "scripts": {
      const base = renderNode(n.base, display);
      // big operators with limits in display mode (or \overset/\underset): stack
      const stacked = n.over || (display && n.base && n.base.k === "op" && n.base.limits);
      if (stacked) {
        const over = n.sup ? `<span class="tex-over">${renderNode(n.sup, false)}</span>` : "";
        const under = n.sub ? `<span class="tex-under">${renderNode(n.sub, false)}</span>` : "";
        return `<span class="tex-stack">${over}<span class="tex-stackbase">${base}</span>${under}</span>`;
      }
      let scripts = "";
      if (n.sup && n.sub) {
        scripts = `<span class="tex-vscripts"><span class="tex-sup">${renderNode(n.sup, false)}</span><span class="tex-sub">${renderNode(n.sub, false)}</span></span>`;
      } else if (n.sup) scripts = `<sup class="tex-sup">${renderNode(n.sup, false)}</sup>`;
      else if (n.sub) scripts = `<sub class="tex-sub">${renderNode(n.sub, false)}</sub>`;
      return base + scripts;
    }
    case "accent": {
      // combining char applied after the last glyph of the body
      const inner = renderNode(n.body, false);
      return `<span class="tex-accent">${inner}${n.ch ? `<span class="tex-accent-mark">${esc(n.ch)}</span>` : ""}</span>`;
    }
    case "ov": {
      const mark = n.brace ? ` tex-brace" data-brace="${esc(n.brace)}` : "";
      return `<span class="tex-overline${mark}">${renderNode(n.body, display)}</span>`;
    }
    case "un":
      return `<span class="tex-underline${n.brace ? ` tex-brace-under" data-brace="${esc(n.brace)}` : ""}">${renderNode(n.body, display)}</span>`;
    case "delim": {
      const l = n.left ? `<span class="tex-delim">${esc(n.left)}</span>` : "";
      const r = n.right ? `<span class="tex-delim">${esc(n.right)}</span>` : "";
      return `<span class="tex-fenced">${l}<span class="tex-fenced-body">${renderList(n.body, display)}</span>${r}</span>`;
    }
    case "env": return renderEnv(n, display);
    default: return "";
  }
}

function renderEnv(n, display) {
  const fences = {
    pmatrix: ["(", ")"], bmatrix: ["[", "]"], Bmatrix: ["{", "}"],
    vmatrix: ["|", "|"], Vmatrix: ["‖", "‖"], matrix: ["", ""],
    cases: ["{", ""], array: ["", ""], aligned: ["", ""], align: ["", ""],
    alignat: ["", ""], gather: ["", ""], split: ["", ""], smallmatrix: ["", ""],
  };
  const [l, r] = fences[n.name] || ["", ""];
  const aligned = ["aligned", "align", "alignat", "split", "cases"].includes(n.name);
  const rowsHtml = n.rows.map(cells =>
    `<span class="tex-mrow">` + cells.map((cell, i) =>
      `<span class="tex-mcell${aligned ? (i % 2 ? " tex-aleft" : " tex-aright") : ""}">${renderList(cell, display)}</span>`
    ).join("") + `</span>`
  ).join("");
  const lHtml = l ? `<span class="tex-delim tex-envdelim">${esc(l)}</span>` : "";
  const rHtml = r ? `<span class="tex-delim tex-envdelim">${esc(r)}</span>` : "";
  return `<span class="tex-fenced">${lHtml}<span class="tex-matrix tex-env-${esc(n.name)}">${rowsHtml}</span>${rHtml}</span>`;
}

// ---------------------------------------------------------------- entry

// Render a TeX string to HTML. display=true for $$..$$ / \[..\] blocks.
// Never throws: on any internal error the raw (escaped) source is shown,
// which is exactly the pre-katex behavior — bad math must not kill the chat.
export function renderTex(tex, display) {
  try {
    const parser = new Parser(tokenize(tex));
    const body = [];
    while (!parser.done()) {
      const atom = parser.parseAtomWithScripts();
      if (atom) body.push(atom); else parser.next();
    }
    const cls = display ? "tex tex-display" : "tex tex-inline";
    return `<span class="${cls}">${renderList(body, !!display)}</span>`;
  } catch (e) {
    return `<span class="tex tex-error" title="TeX parse error">${esc(tex)}</span>`;
  }
}
