// Tiny client-side state store (zustand-style, reference frontend/src/stores):
// one source of truth per domain; views subscribe and re-render their region.

export function createStore(initial) {
  let state = initial;
  const subs = new Set();
  return {
    get: () => state,
    set: (patch) => {
      state = {...state, ...(typeof patch === "function" ? patch(state) : patch)};
      subs.forEach(fn => fn(state));
    },
    subscribe: (fn) => { subs.add(fn); return () => subs.delete(fn); },
  };
}
