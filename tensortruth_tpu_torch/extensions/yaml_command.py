"""YAML-defined commands: template interpolation + step execution.

Mirrors reference extensions/yaml_command.py:1-383: ``{{args}}`` and
``{{var}}`` / ``{{var.group}}`` interpolation, sequential tool steps with
result variables and regex extraction, agent delegation, output template.
"""

from __future__ import annotations

import json
import re
from typing import AsyncIterator

from tensortruth_tpu_torch.extensions.schema import CommandSpec
from tensortruth_tpu_torch.server.commands import ToolCommand

_VAR_RE = re.compile(r"\{\{\s*([\w.]+)\s*\}\}")


def interpolate(template: str, variables: dict) -> str:
    def sub(m: re.Match) -> str:
        path = m.group(1).split(".")
        value = variables.get(path[0], "")
        for key in path[1:]:
            if isinstance(value, dict):
                value = value.get(key, "")
            elif isinstance(value, re.Match):
                try:
                    value = value.group(int(key) if key.isdigit() else key)
                except (IndexError, KeyError):
                    value = ""
            else:
                value = getattr(value, key, "")
        if isinstance(value, (dict, list)):
            return json.dumps(value, ensure_ascii=False)
        return str(value)

    return _VAR_RE.sub(sub, template)


def interpolate_params(params: dict, variables: dict):
    """Recursive interpolation over step params."""
    if isinstance(params, str):
        return interpolate(params, variables)
    if isinstance(params, dict):
        return {k: interpolate_params(v, variables) for k, v in params.items()}
    if isinstance(params, list):
        return [interpolate_params(v, variables) for v in params]
    return params


class YamlCommand(ToolCommand):
    is_user_command = True

    def __init__(self, spec: CommandSpec, tool_service):
        self.spec = spec
        self.tool_service = tool_service
        self.name = spec.name
        self.aliases = spec.aliases
        self.description = spec.description
        self.usage = spec.usage or f"/{spec.name} <args>"

    async def execute(self, args: str, context: dict) -> AsyncIterator[dict]:
        variables: dict = {"args": args}
        last_result = ""
        if self.spec.agent:
            from tensortruth_tpu_torch.agents.registry import AgentFactoryRegistry

            agent = AgentFactoryRegistry.get_instance().create(self.spec.agent, context)
            answered = False
            async for event in agent.run(args, context):
                # translate the agent's final answer into the WS protocol the
                # chat route/frontend consume (token + done) — raw agent_done
                # is invisible to both (same translation the orchestrator does)
                if event.get("type") == "agent_done":
                    answered = True
                    yield {"type": "token", "content": event.get("content", "")}
                else:
                    yield event
            yield {"type": "done"} if answered else {
                "type": "error", "error": "agent produced no answer"
            }
            return
        for i, step in enumerate(self.spec.steps):
            yield {
                "type": "status",
                "status": "tool",
                "message": f"step {i + 1}/{len(self.spec.steps)}: {step.tool}",
            }
            params = interpolate_params(step.params, variables)
            result = await self.tool_service.execute_tool(step.tool, **params)
            text = result if isinstance(result, str) else json.dumps(result, ensure_ascii=False)
            if step.result_extract:
                m = re.search(step.result_extract, text, re.DOTALL)
                text = m.group(1) if m and m.groups() else (m.group(0) if m else "")
            if step.result_var:
                variables[step.result_var] = text
            last_result = text
        variables["last_result"] = last_result
        yield {"type": "token", "content": interpolate(self.spec.output_template, variables)}
        yield {"type": "done"}
