// Minimal hash router (the no-build analog of the reference's
// react-router paths: /projects/:id, settings panels, chat sessions):
// views WRITE their location via setRoute() and the app restores deep
// links on load — #manage/system opens the System panel, #project/<id>
// the project page, #session/<id> that conversation. History back/forward
// replays through the same apply function.

let applying = false;  // guard: applying a hash must not re-write it
let lastSet = null;    // guard: our own hash writes must not re-apply —
                       // hashchange fires asynchronously after setRoute,
                       // outside the `applying` window

export function setRoute(route) {
  if (applying) return;
  try {
    if (location.hash.slice(1) !== route) {
      lastSet = route;
      location.hash = route;
    }
  } catch (e) {}
}

export function currentRoute() {
  try { return location.hash.slice(1); } catch (e) { return ""; }
}

// handlers: {manage(panel), project(id), session(id), chat()}
export function applyRoute(route, handlers) {
  applying = true;
  try {
    const [kind, arg] = (route || "").split("/", 2);
    if (kind === "manage") handlers.manage(arg || undefined);
    else if (kind === "project" && arg) handlers.project(arg);
    else if (kind === "session" && arg) handlers.session(arg);
    else handlers.chat();
  } finally {
    applying = false;
  }
}

export function wireRouter(handlers) {
  const onHash = () => {
    const route = currentRoute();
    if (route === lastSet) { lastSet = null; return; }  // echo of our write
    applyRoute(route, handlers);
  };
  try { window.addEventListener("hashchange", onHash); } catch (e) {}
  return onHash;
}
