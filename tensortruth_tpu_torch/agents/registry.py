"""Agent factory registry (reference agents/factory.py:16-80 +
services/agent_service.py): named factories (built-in + YAML user agents),
creation with context."""

from __future__ import annotations

import threading
from typing import Callable

from tensortruth_tpu_torch.agents.base import Agent


class AgentFactoryRegistry:
    _instance: "AgentFactoryRegistry | None" = None
    _lock = threading.Lock()

    def __init__(self):
        self._factories: dict[str, Callable[[dict], Agent]] = {}
        self._descriptions: dict[str, str] = {}
        self._user_agents: set[str] = set()
        self._register_builtins()

    @classmethod
    def get_instance(cls) -> "AgentFactoryRegistry":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def _register_builtins(self) -> None:
        from tensortruth_tpu_torch.agents.function_agent import FunctionAgent

        self.register(
            "function",
            lambda ctx: FunctionAgent(context=ctx),
            "Tool-calling loop agent (orchestrator core)",
        )

    def register(self, name: str, factory: Callable[[dict], Agent], description: str = "", user: bool = False) -> None:
        self._factories[name] = factory
        self._descriptions[name] = description
        if user:
            self._user_agents.add(name)

    def register_yaml_agent(self, spec) -> None:
        from tensortruth_tpu_torch.agents.function_agent import FunctionAgent

        self.register(
            spec.name,
            lambda ctx, s=spec: FunctionAgent(
                context=ctx,
                system_prompt=s.system_prompt,
                allowed_tools=s.tools or None,
                max_iterations=s.max_iterations,
                model=s.model,
            ),
            spec.description,
            user=True,
        )

    def clear_user_agents(self) -> None:
        for name in list(self._user_agents):
            self._factories.pop(name, None)
            self._descriptions.pop(name, None)
        self._user_agents.clear()

    def create(self, name: str, context: dict) -> Agent:
        if name not in self._factories:
            raise KeyError(f"unknown agent: {name}")
        return self._factories[name](context)

    def list_agents(self) -> list[dict]:
        return [
            {"name": n, "description": self._descriptions.get(n, ""),
             "user": n in self._user_agents}
            for n in sorted(self._factories)
        ]
