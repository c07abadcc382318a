// Startup wizard (reference frontend/src/components/startup): first-run
// flow — environment check → provider setup (test + model discovery) →
// index build/download with live task progress → model pull → first
// session.

import {addProvider, testProvider} from "../api/providers.js";
import {availableIndexes, downloadIndexes, pullModel, startupStatus} from "../api/startup.js";
import {systemDevices, systemMemory} from "../api/system.js";
import {watchTask} from "../api/tasks.js";
import {$, el} from "../lib/dom.js";
import {currentSessionId} from "../stores/session.js";
import {uiStore} from "../stores/ui.js";
import {rowItem, showManage} from "../views/manage.js";
import {loadModules} from "../views/sidebar.js";

const WIZARD_STEPS = ["Welcome", "Provider", "Knowledge", "Model", "Done"];

export function wizardShow(show) {
  $("wizard").style.display = show ? "flex" : "none";
  if (show) { uiStore.set({wizardStep: 0}); wizardRender(); }
}

function wizardRender() {
  const step = uiStore.get().wizardStep;
  const stepsBox = $("wizard-steps"); stepsBox.innerHTML = "";
  WIZARD_STEPS.forEach((_, i) => {
    stepsBox.appendChild(el("div", "wstep" + (i <= step ? " done" : "")));
  });
  $("wizard-title").textContent = `${WIZARD_STEPS[step]} (${step + 1}/${WIZARD_STEPS.length})`;
  $("wizard-back").style.visibility = step > 0 ? "visible" : "hidden";
  $("wizard-next").textContent = step === WIZARD_STEPS.length - 1 ? "Finish" : "Next";
  const body = $("wizard-body"); body.innerHTML = "";
  WIZARD_RENDERERS[step](body);
}

const WIZARD_RENDERERS = [
  async body => {  // 0 Welcome: environment check
    body.appendChild(el("p", "", "Local-first RAG for technical documentation, running retrieval on TPU via JAX/XLA/Pallas. This wizard checks your environment, connects an LLM provider, and builds your first knowledge index."));
    const kv = el("div", "kv"); body.appendChild(kv);
    const put = (k, v) => { kv.appendChild(el("div", "k", k)); kv.appendChild(el("div", "", v)); };
    try {
      const [devices, mem] = await Promise.all([systemDevices(), systemMemory()]);
      put("compute backend", devices.backend || "?");
      put("devices", (devices.devices || []).map(d => d.kind || d.platform).join(", ") || "—");
      const gb = b => (b / 1024 / 1024 / 1024).toFixed(1);
      put("host RAM", mem.ram?.total ? `${gb(mem.ram.available)} GB free of ${gb(mem.ram.total)}` : "—");
      put("status", "✓ environment OK");
    } catch (e) { put("status", "✗ API unreachable: " + e); }
  },
  async body => {  // 1 Provider
    body.appendChild(el("p", "", "Connect an LLM provider (Ollama, llama.cpp, or any OpenAI-compatible server). Retrieval runs locally either way."));
    const form = el("div", "mini-form");
    form.innerHTML = `
      <select id="wiz-ptype"><option value="ollama">ollama</option>
        <option value="openai_compatible">openai_compatible</option>
        <option value="llama_cpp">llama_cpp</option></select>
      <input id="wiz-purl" placeholder="base URL (e.g. http://localhost:11434)" size="32">
      <input id="wiz-pkey" placeholder="API key (optional)" size="14">`;
    body.appendChild(form);
    const testBtn = el("button", "hbtn", "Test connection");
    const out = el("div", "dim", "");
    const modelsBox = el("div", "row-list");
    testBtn.onclick = async () => {
      out.textContent = "testing…";
      const r = await testProvider({
        type: $("wiz-ptype").value, base_url: $("wiz-purl").value, api_key: $("wiz-pkey").value,
      });
      out.textContent = r.ok ? `✓ reachable — ${(r.models || []).length} models` : `✗ ${r.error || "unreachable"}`;
      modelsBox.innerHTML = "";
      for (const m of (r.models || []).slice(0, 12))
        modelsBox.appendChild(rowItem(String(m.id || m.name || m), "", []));
      if (r.ok) {
        await addProvider({
          id: "wizard-" + $("wiz-ptype").value, type: $("wiz-ptype").value,
          base_url: $("wiz-purl").value, api_key: $("wiz-pkey").value,
        }).catch(() => {});
      }
    };
    body.appendChild(testBtn);
    body.appendChild(out);
    body.appendChild(modelsBox);
  },
  async body => {  // 2 Knowledge: build/download indexes with progress
    const status = await startupStatus();
    body.appendChild(el("p", "", status.indexes_present
      ? `✓ ${status.index_count} index(es) already built: ${(status.modules_configured || []).join(", ")}`
      : "No knowledge indexes yet. Build from configured sources, or download a pre-built bundle."));
    const box = el("div", "row-list"); body.appendChild(box);
    const avail = await availableIndexes().catch(() => ({indexes: []}));
    for (const ix of avail.indexes || []) {
      box.appendChild(rowItem(ix.name || ix.module, ix.embedding_model || "", [
        ["Download", "primary", async ev => {
          const r = await downloadIndexes([ix.module || ix.name]);
          const bar = el("div", "progress"); bar.appendChild(el("div"));
          ev.target.parentElement.appendChild(bar);
          if (r.task_id) watchTask(r.task_id, t => {
            bar.firstElementChild.style.width = t.total ? `${100 * t.progress / t.total}%` : "50%";
            ev.target.textContent = t.status === "completed" ? "✓" : t.status === "failed" ? "✗" : "…";
          });
        }],
      ]));
    }
    if (!(avail.indexes || []).length && (status.modules_configured || []).length) {
      const b = el("button", "hbtn", `Build ${(status.modules_configured || []).length} configured module(s)`);
      const prog = el("div", "dim", "");
      b.onclick = async () => {
        const r = await downloadIndexes();
        if (r.task_id) watchTask(r.task_id, t => {
          prog.textContent = `${t.status} · ${t.stage || ""} ${t.total ? `(${t.progress}/${t.total})` : ""}`;
        });
      };
      body.appendChild(b); body.appendChild(prog);
    }
    if (!(avail.indexes || []).length && !(status.modules_configured || []).length)
      body.appendChild(el("p", "dim", "No sources configured — add them later with tensor-truth-tpu-docs, or upload documents per session."));
  },
  async body => {  // 3 Model pull
    body.appendChild(el("p", "", "Pull an LLM for generation (Ollama providers). Skip if your provider already serves models."));
    const form = el("div", "mini-form");
    const inp = document.createElement("input");
    inp.id = "wiz-model"; inp.placeholder = "e.g. llama3.1:8b"; inp.size = 24;
    const b = el("button", "hbtn", "Pull model");
    const prog = el("div", "dim", "");
    b.onclick = async () => {
      prog.textContent = "starting pull…";
      const r = await pullModel(inp.value);
      if (r.task_id) watchTask(r.task_id, t => {
        prog.textContent = `${t.status} ${t.stage || ""}`;
      });
    };
    form.appendChild(inp); form.appendChild(b);
    body.appendChild(form); body.appendChild(prog);
  },
  async body => {  // 4 Done
    body.appendChild(el("p", "", "Setup complete. You can revisit any step from Manage → Startup. Finishing creates your first session."));
    const status = await startupStatus();
    const kv = el("div", "kv"); body.appendChild(kv);
    const put = (k, v) => { kv.appendChild(el("div", "k", k)); kv.appendChild(el("div", "", String(v))); };
    put("indexes", status.indexes_present ? `${status.index_count} built` : "none (sessions can still upload documents)");
    put("embedding model", status.default_embedding_model || "—");
  },
];

export function wireWizard() {
  $("wizard-next").onclick = async () => {
    const step = uiStore.get().wizardStep;
    if (step >= WIZARD_STEPS.length - 1) {
      wizardShow(false);
      localStorage.setItem("tt_wizard_done", "1");
      await loadModules();
      if (!currentSessionId()) $("new-session").click();
      return;
    }
    uiStore.set({wizardStep: step + 1});
    wizardRender();
  };
  $("wizard-back").onclick = () => {
    uiStore.set({wizardStep: Math.max(0, uiStore.get().wizardStep - 1)});
    wizardRender();
  };
  $("wizard-skip").onclick = () => {
    wizardShow(false);
    localStorage.setItem("tt_wizard_done", "1");
    // On a fresh install the wizard opened before any session existed —
    // skipping must still leave a live session or the composer is dead.
    if (!currentSessionId()) $("new-session").click();
  };
  $("wizard-open").onclick = () => { showManage(false); wizardShow(true); };
}
