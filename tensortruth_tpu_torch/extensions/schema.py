"""YAML extension schema (reference extensions/schema.py:27-65).

``CommandSpec`` — a slash command defined either as a tool-step pipeline
(steps) XOR a delegation to a named agent. ``StepSpec`` — one tool call with
templated params, an optional result variable and regex extraction.
``AgentSpec`` — a YAML-defined agent (tools, system prompt, model).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class ExtensionError(ValueError):
    """Schema validation failure (reference extensions/errors.py)."""


@dataclass
class StepSpec:
    tool: str
    params: dict = field(default_factory=dict)
    result_var: str | None = None
    result_extract: str | None = None  # regex with one group

    @classmethod
    def from_dict(cls, d: dict) -> "StepSpec":
        if not d.get("tool"):
            raise ExtensionError("step requires a 'tool'")
        return cls(
            tool=d["tool"],
            params=d.get("params", {}),
            result_var=d.get("result_var"),
            result_extract=d.get("result_extract"),
        )


@dataclass
class CommandSpec:
    name: str
    description: str = ""
    usage: str = ""
    aliases: list[str] = field(default_factory=list)
    steps: list[StepSpec] = field(default_factory=list)
    agent: str | None = None
    output_template: str = "{{last_result}}"

    @classmethod
    def from_dict(cls, d: dict) -> "CommandSpec":
        if not d.get("name"):
            raise ExtensionError("command requires a 'name'")
        steps = [StepSpec.from_dict(s) for s in d.get("steps", [])]
        agent = d.get("agent")
        if bool(steps) == bool(agent):
            raise ExtensionError(
                f"command '{d['name']}' must define steps XOR agent"
            )
        return cls(
            name=d["name"],
            description=d.get("description", ""),
            usage=d.get("usage", ""),
            aliases=list(d.get("aliases", [])),
            steps=steps,
            agent=agent,
            output_template=d.get("output_template", "{{last_result}}"),
        )


@dataclass
class AgentSpec:
    name: str
    description: str = ""
    tools: list[str] = field(default_factory=list)
    system_prompt: str = ""
    model: str | None = None
    max_iterations: int = 10

    @classmethod
    def from_dict(cls, d: dict) -> "AgentSpec":
        if not d.get("name"):
            raise ExtensionError("agent requires a 'name'")
        return cls(
            name=d["name"],
            description=d.get("description", ""),
            tools=list(d.get("tools", [])),
            system_prompt=d.get("system_prompt", ""),
            model=d.get("model"),
            max_iterations=int(d.get("max_iterations", 10)),
        )
