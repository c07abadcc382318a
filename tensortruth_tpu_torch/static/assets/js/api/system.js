// Typed client for /api/system (reference frontend/src/api/system.ts):
// memory/devices introspection, RAG engine status, runtime status and
// load/unload, engine restart, profiler control.

import {api, post} from "./client.js";

export function systemMemory() { return api("/system/memory"); }
export function systemDevices() { return api("/system/devices"); }
export function ragStatus() { return api("/system/rag/status"); }
export function runtimeStatus(runtime) { return api(`/system/${runtime}/status`); }
export function runtimeUnload(runtime, body) { return post(`/system/${runtime}/unload`, body || {}); }
export function runtimeLoad(runtime, body) { return post(`/system/${runtime}/load`, body || {}); }
export function restartEngine() { return post("/system/restart-engine"); }
export function unloadModels() { return post("/system/models/unload"); }
export function profileStart() { return post("/system/profile/start", {}); }
export function profileStop() { return post("/system/profile/stop"); }
