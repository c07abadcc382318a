// Session-domain state (reference frontend/src/stores/sessionStore.ts):
// the session list, the open session, and its display title.

import {createStore} from "./store.js";

export const sessionStore = createStore({sessions: [], current: null, title: ""});

export function currentSessionId() { return sessionStore.get().current; }
