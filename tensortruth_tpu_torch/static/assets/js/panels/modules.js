// Knowledge-modules panel (reference components/modules/* +
// components/config rerankers section, api/routes/rerankers.py): built
// module indexes, known embedding models, and reranker registry
// management — add with server-side architecture validation (422
// surfaced), per-model remove.

import {
  addReranker, listEmbeddingModels, listModules, listRerankers,
  removeReranker,
} from "../api/modules.js";
import {$, el, toast} from "../lib/dom.js";
import {rowItem} from "../views/manage.js";

export async function loadModulesPanel() {
  const [mods, models, rerankers] = await Promise.all([
    listModules(), listEmbeddingModels().catch(() => ({models: []})),
    listRerankers().catch(() => ({rerankers: []})),
  ]);
  const box = $("modules-list"); box.innerHTML = "";
  if (!mods.modules.length) box.appendChild(el("div", "dim", "No module indexes built. Use tensor-truth-tpu-build."));
  for (const m of mods.modules)
    box.appendChild(rowItem(m.module, `${m.doc_type} · ${m.n_chunks ?? "?"} chunks`, []));
  const mbox = $("embedding-models-list"); mbox.innerHTML = "";
  for (const m of models.models || []) mbox.appendChild(rowItem(m, "", []));
  const rbox = $("rerankers-list"); rbox.innerHTML = "";
  for (const m of rerankers.rerankers || []) {
    rbox.appendChild(rowItem(m, "", [
      ["Remove", "danger", async () => {
        const r = await removeReranker(m);
        if (r && r.error) toast(r.error, true);
        loadModulesPanel();
      }],
    ]));
  }
  // add-reranker form (reference rerankers add with HF validation — the
  // server validates against its architecture registry and answers 422)
  const form = el("div", "mini-form");
  const inp = el("input", "reranker-input");
  inp.placeholder = "reranker id (e.g. BAAI/bge-reranker-v2-m3)";
  inp.size = 34;
  form.appendChild(inp);
  const add = el("button", "primary reranker-add", "Add reranker");
  add.onclick = async () => {
    const id = inp.value.trim();
    if (!id) return;
    const r = await addReranker(id);
    if (r.ok) {
      inp.value = "";
      toast(`registered ${id}`);
      loadModulesPanel();
    } else {
      const text = await r.text().catch(() => "");
      toast(`add failed (${r.status}): ${text.slice(0, 120)}`, true);
    }
  };
  form.appendChild(add);
  rbox.appendChild(form);
}
