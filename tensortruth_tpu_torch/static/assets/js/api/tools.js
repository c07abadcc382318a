// Typed client for the agent-tool surfaces (reference
// frontend/src/api/tools.ts): loaded tools, slash commands, named agents.

import {api} from "./client.js";

export function listTools() { return api("/tools"); }
export function listCommands() { return api("/commands"); }
export function listAgents() { return api("/agents"); }
