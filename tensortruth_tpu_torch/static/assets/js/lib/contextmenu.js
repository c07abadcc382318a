// Generic right-click context menu (reference frontend
// components/ui/context-menu.tsx, radix ContextMenu reduced to the
// no-framework essentials): one floating menu at a time, positioned at
// the pointer, dismissed by any click elsewhere or Escape. Items carry a
// label, an optional danger style, and an onPick handler.

import {el} from "./dom.js";

let openMenu = null;

export function closeContextMenu() {
  if (openMenu) openMenu.remove();
  openMenu = null;
}

export function showContextMenu(x, y, items) {
  closeContextMenu();
  const menu = el("div", "ctx-menu");
  for (const item of items) {
    if (item === "---") { menu.appendChild(el("div", "ctx-sep", "")); continue; }
    const row = el("div", "ctx-item" + (item.danger ? " danger" : ""),
                   item.label);
    row.onclick = ev => {
      ev.stopPropagation();
      closeContextMenu();
      item.onPick();
    };
    menu.appendChild(row);
  }
  menu.style.left = `${x}px`;
  menu.style.top = `${y}px`;
  document.body.appendChild(menu);
  openMenu = menu;
  return menu;
}

// Attach a context menu to an element; builder runs per-open so items see
// fresh state.
export function onContextMenu(elem, buildItems) {
  elem.oncontextmenu = ev => {
    ev.preventDefault();
    ev.stopPropagation();
    showContextMenu(ev.clientX || 40, ev.clientY || 40, buildItems());
  };
}

export function wireContextMenuDismiss() {
  document.addEventListener("click", () => closeContextMenu());
  document.addEventListener("keydown", ev => {
    if (ev.key === "Escape") closeContextMenu();
  });
}
