// Typed client for /api/mcp-servers (reference frontend/src/api/mcp.ts).

import {api, del, patch, post} from "./client.js";

export function listMcpServers() { return api("/mcp-servers"); }
export function mcpPresets() { return api("/mcp-servers/presets"); }
export function addMcpServer(body) { return post("/mcp-servers", body); }
export function patchMcpServer(name, body) { return patch(`/mcp-servers/${name}`, body); }
export function toggleMcpServer(name) { return patch(`/mcp-servers/${name}/toggle`); }
export function deleteMcpServer(name) { return del(`/mcp-servers/${name}`); }
