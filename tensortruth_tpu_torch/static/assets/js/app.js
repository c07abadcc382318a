// App bootstrap (reference frontend/src/App.tsx + main.tsx): wire every
// self-contained view module, apply the persisted theme, register global
// keybindings, then run the initial data load — and open the startup
// wizard on a genuinely fresh install.

import {sessionStats} from "./api/sessions.js";
import {startupStatus} from "./api/startup.js";
import {systemDevices} from "./api/system.js";
import {wireComposer} from "./chat/composer.js";
import {wireModelSelect} from "./chat/modelselect.js";
import {wireModulePicker} from "./chat/modulepicker.js";
import {wireParamsDrawer} from "./chat/params.js";
import {stopStreaming} from "./chat/ws.js";
import {wireContextMenuDismiss} from "./lib/contextmenu.js";
import {$, toast} from "./lib/dom.js";
import {applyRoute, currentRoute, wireRouter} from "./lib/router.js";
import {wireConfigPanel} from "./panels/config.js";
import {wireDocumentsPanel} from "./panels/documents.js";
import {wireExtensionsPanel} from "./panels/extensions.js";
import {wireMcpPanel} from "./panels/mcp.js";
import {wireProjectsPanel} from "./panels/projects.js";
import {wireProvidersPanel} from "./panels/providers.js";
import {wireSystemPanel} from "./panels/system.js";
import {sessionStore} from "./stores/session.js";
import {showManage, wireManage} from "./views/manage.js";
import {openProjectView, showProjectView} from "./views/project.js";
import {wireMemstrip} from "./views/memstrip.js";
import {
  loadModules, loadProjects, loadSessions, openSession, wireSidebar,
} from "./views/sidebar.js";
import {wireWizard, wizardShow} from "./wizard/wizard.js";

// Light/dark theme toggle (reference frontend ThemeToggle.tsx), persisted.
function applyTheme(t) {
  document.body.classList.toggle("light", t === "light");
  try { localStorage.setItem("tt-theme", t); } catch (e) {}
}

function wireChrome() {
  // Global error surface (≡ the reference's React error boundary): a
  // handler exception or unhandled rejection shows a toast instead of
  // dying silently in the console. Guarded — jsrt's CI runtime has no
  // `window` object.
  try {
    window.addEventListener("error", ev =>
      toast("UI error: " + (ev.message || ev.error || "unknown"), true));
    window.addEventListener("unhandledrejection", ev =>
      toast("UI error: " + (ev.reason && ev.reason.message || ev.reason), true));
  } catch (e) {}

  $("theme-btn").onclick = () =>
    applyTheme(document.body.classList.contains("light") ? "dark" : "light");
  try { applyTheme(localStorage.getItem("tt-theme") || "dark"); } catch (e) {}

  $("stop-btn").onclick = () => stopStreaming();

  // Mobile sidebar drawer (≤900px, app.css): toggle from the header,
  // dismiss by tapping the scrim or picking a session.
  $("sidebar-btn").onclick = () =>
    document.body.classList.toggle("sidebar-open");
  document.addEventListener("click", ev => {
    if (!document.body.classList.contains("sidebar-open")) return;
    const inAside = ev.target.closest("aside");
    if (!inAside && ev.target.id !== "sidebar-btn")
      document.body.classList.remove("sidebar-open");
    else if (inAside && ev.target.closest(".session"))
      document.body.classList.remove("sidebar-open");
  });

  // Jump-to-latest pill (reference useScrollDirection + MessageList's
  // scroll-to-bottom affordance): appears once the reader scrolls away
  // from the bottom, one click re-pins the stream.
  $("messages").addEventListener("scroll", () => {
    const box = $("messages");
    const away = box.scrollHeight - box.scrollTop - box.clientHeight > 300;
    $("jump-latest").style.display = away ? "block" : "none";
  });
  $("jump-latest").onclick = () => {
    const box = $("messages");
    box.scrollTop = box.scrollHeight;
    $("jump-latest").style.display = "none";
  };

  $("status-bar").onclick = async () => {
    try {
      const stats = await sessionStats();
      toast(`${stats.total_sessions ?? "?"} sessions · ` +
            `${stats.total_messages ?? "?"} messages`);
    } catch (e) { toast(String(e), true); }
  };

  document.addEventListener("keydown", ev => {
    if ((ev.ctrlKey || ev.metaKey) && ev.key === "k") {
      ev.preventDefault();
      $("session-filter").focus();
    } else if (ev.key === "Escape") {
      if ($("params-drawer").style.display === "block")
        $("params-drawer").style.display = "none";
      else if ($("project-view").style.display === "flex") showProjectView(false);
      else if ($("manage").style.display === "flex") showManage(false);
    }
  });
}

async function init() {
  let status = null;
  try {
    const [st, devices] = await Promise.all([startupStatus(), systemDevices()]);
    status = st;
    $("status-bar").textContent =
      `${devices.backend} · ${st.index_count} indexes · ` +
      `${st.modules_configured.length} modules`;
  } catch (e) { $("status-bar").textContent = "API unreachable"; }
  await Promise.all([loadSessions(), loadModules(), loadProjects()]);
  // first run (no indexes, no sessions, wizard never completed) → wizard
  const fresh = status && !status.indexes_present &&
    !sessionStore.get().sessions.length && !localStorage.getItem("tt_wizard_done");
  if (fresh) { wizardShow(true); return; }
  // Deep link restore (≡ reference react-router paths): #manage/<panel>,
  // #project/<id>, #session/<id>; back/forward replay the same handlers.
  const routeHandlers = {
    manage: panel => showManage(true, panel),
    project: id => { showManage(false); openProjectView(id); },
    session: id => { showManage(false); showProjectView(false); openSession(id); },
    chat: () => { showManage(false); showProjectView(false); },
  };
  wireRouter(routeHandlers);
  const deep = currentRoute();
  if (deep) { applyRoute(deep, routeHandlers); return; }
  // scope to #sessions: project rows share the .session class, and
  // clicking one would silently mint a new project session on every load
  const existing = document.querySelector("#sessions .session");
  if (existing) existing.click(); else $("new-session").click();
}

wireSidebar();
wireManage();
wireComposer();
wireModelSelect();
wireModulePicker();
wireMemstrip();
wireParamsDrawer();
wireWizard();
wireChrome();
wireContextMenuDismiss();
wireProvidersPanel();
wireDocumentsPanel();
wireProjectsPanel();
wireConfigPanel();
wireSystemPanel();
wireExtensionsPanel();
wireMcpPanel();
init();
