// Minimal syntax highlighter for fenced code blocks — the vendored
// replacement for the reference's rehype-highlight (frontend/package.json:48).
// Single-pass regex tokenizer per language family; emits <span class="hl-*">
// wrapped, HTML-escaped tokens. Unknown languages fall back to escaped text.

function esc(s) {
  return s.replace(/&/g, "&amp;").replace(/</g, "&lt;").replace(/>/g, "&gt;")
    .replace(/"/g, "&quot;").replace(/'/g, "&#39;");
}

const KW = {
  python: "False None True and as assert async await break class continue def del elif else except finally for from global if import in is lambda nonlocal not or pass raise return try while with yield match case self cls",
  js: "abstract arguments async await break case catch class const continue debugger default delete do else enum export extends false finally for from function get if implements import in instanceof interface let new null of private protected public return set static super switch this throw true try typeof undefined var void while with yield type",
  c: "alignas alignof auto bool break case catch char class const constexpr const_cast continue decltype default delete do double dynamic_cast else enum explicit extern false final float for friend goto if inline int long mutable namespace new noexcept nullptr operator override private protected public register reinterpret_cast restrict return short signed sizeof static static_assert static_cast struct switch template this throw true try typedef typeid typename union unsigned using virtual void volatile wchar_t while int8_t int16_t int32_t int64_t uint8_t uint16_t uint32_t uint64_t size_t ssize_t",
  bash: "if then else elif fi for while until do done case esac function in select time coproc break continue return exit export local readonly declare unset shift source alias echo printf read cd pwd test set trap eval exec wait true false",
  sql: "select from where insert into values update set delete create table drop alter index join inner left right outer on as and or not null primary key foreign references group by order having limit offset distinct union all exists between like in is count sum avg min max",
  rust: "as async await break const continue crate dyn else enum extern false fn for if impl in let loop match mod move mut pub ref return self Self static struct super trait true type unsafe use where while",
  go: "break case chan const continue default defer else fallthrough for func go goto if import interface map package range return select struct switch type var nil true false",
  java: "abstract assert boolean break byte case catch char class const continue default do double else enum extends final finally float for goto if implements import instanceof int interface long native new package private protected public return short static strictfp super switch synchronized this throw throws transient try void volatile while var record sealed true false null",
};
const ALIASES = {
  py: "python", python3: "python", javascript: "js", typescript: "js", ts: "js",
  jsx: "js", tsx: "js", node: "js", cpp: "c", "c++": "c", cc: "c", h: "c",
  hpp: "c", cuda: "c", sh: "bash", shell: "bash", zsh: "bash", console: "bash",
  golang: "go", yml: "yaml",
};

function kwSet(lang) {
  const s = new Set();
  for (const w of (KW[lang] || "").split(" ")) if (w) s.add(w);
  return s;
}
const KWSETS = {};
for (const k of Object.keys(KW)) KWSETS[k] = kwSet(k);

// Ordered token rules per language family. First match at position wins.
function rules(lang) {
  const r = [];
  if (lang === "python") {
    r.push([/^(#[^\n]*)/, "hl-com"]);
    r.push([/^("""[\s\S]*?"""|'''[\s\S]*?''')/, "hl-str"]);
    r.push([/^([rbfu]{0,2}"(?:\\.|[^"\\\n])*"|[rbfu]{0,2}'(?:\\.|[^'\\\n])*')/i, "hl-str"]);
    r.push([/^(@[A-Za-z_][\w.]*)/, "hl-meta"]);
  } else if (lang === "js" || lang === "c" || lang === "rust" || lang === "go" || lang === "java") {
    r.push([/^(\/\/[^\n]*)/, "hl-com"]);
    r.push([/^(\/\*[\s\S]*?\*\/)/, "hl-com"]);
    r.push([/^(`(?:\\.|[^`\\])*`)/, "hl-str"]);
    r.push([/^("(?:\\.|[^"\\\n])*"|'(?:\\.|[^'\\\n])*')/, "hl-str"]);
    if (lang === "c") r.push([/^(#\s*\w+)/, "hl-meta"]);
    if (lang === "rust" || lang === "java") r.push([/^(#!?\[[^\]]*\]|@[A-Za-z_][\w.]*)/, "hl-meta"]);
  } else if (lang === "bash") {
    r.push([/^(#[^\n]*)/, "hl-com"]);
    r.push([/^("(?:\\.|[^"\\])*"|'[^']*')/, "hl-str"]);
    r.push([/^(\$\{[^}]*\}|\$\w+)/, "hl-var"]);
  } else if (lang === "sql") {
    r.push([/^(--[^\n]*)/, "hl-com"]);
    r.push([/^('(?:''|[^'])*')/, "hl-str"]);
  } else if (lang === "yaml") {
    r.push([/^(#[^\n]*)/, "hl-com"]);
    r.push([/^("(?:\\.|[^"\\\n])*"|'[^'\n]*')/, "hl-str"]);
    r.push([/^([A-Za-z_][\w\- .]*)(?=:(\s|$))/, "hl-attr"]);
    r.push([/^(&\w+|\*\w+|!!\w+)/, "hl-meta"]);
  } else if (lang === "json") {
    r.push([/^("(?:\\.|[^"\\])*")(?=\s*:)/, "hl-attr"]);
    r.push([/^("(?:\\.|[^"\\])*")/, "hl-str"]);
    r.push([/^(true|false|null)\b/, "hl-kw"]);
  }
  r.push([/^(0[xX][0-9a-fA-F_]+|\d[\d_]*\.?\d*(?:[eE][+-]?\d+)?[fFlLuU]*)/, "hl-num"]);
  return r;
}

export function highlight(code, lang) {
  lang = (lang || "").toLowerCase();
  lang = ALIASES[lang] || lang;
  const kws = KWSETS[lang];
  const rs = rules(lang);
  if (!kws && !["json", "yaml"].includes(lang)) return esc(code);

  let out = "", i = 0;
  outer: while (i < code.length) {
    const rest = code.slice(i);
    for (const [re, cls] of rs) {
      const m = re.exec(rest);
      if (m) {
        out += `<span class="${cls}">${esc(m[1])}</span>`;
        i += m[1].length;
        continue outer;
      }
    }
    const w = /^[A-Za-z_]\w*/.exec(rest);
    if (w) {
      const word = w[0];
      if (kws && kws.has(word)) out += `<span class="hl-kw">${esc(word)}</span>`;
      else if (/^[A-Z]/.test(word) && (lang === "python" || lang === "js" || lang === "c" || lang === "rust" || lang === "go" || lang === "java"))
        out += `<span class="hl-type">${esc(word)}</span>`;
      else if (code[i + word.length] === "(")
        out += `<span class="hl-fn">${esc(word)}</span>`;
      else out += esc(word);
      i += word.length;
      continue;
    }
    out += esc(code[i]);
    i++;
  }
  return out;
}
