// UI-domain state (reference frontend/src/stores/uiStore.ts): which view is
// active (chat vs manage), the selected management tab, the wizard step —
// plus the background-task watch table.

import {createStore} from "./store.js";

export const uiStore = createStore({view: "chat", tab: "providers", wizardStep: 0});
export const taskStore = createStore({tasks: [], watching: {}});
