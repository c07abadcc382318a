"""Slash-command registry for the chat WS (`/help`, `/web`, user commands).

Mirrors reference api/routes/commands.py:31-320: ``ToolCommand`` ABC,
registry with alias map + user-command unregistration, built-in
``HelpCommand`` and ``WebSearchCommand``.
"""

from __future__ import annotations

import logging
from typing import AsyncIterator

logger = logging.getLogger(__name__)


class ToolCommand:
    name: str = ""
    aliases: list[str] = []
    description: str = ""
    usage: str = ""
    is_user_command: bool = False

    async def execute(self, args: str, context: dict) -> AsyncIterator[dict]:
        """Yields WS message dicts ({"type": "token"|"status"|..., ...})."""
        raise NotImplementedError
        yield  # pragma: no cover


class CommandRegistry:
    def __init__(self):
        self._commands: dict[str, ToolCommand] = {}
        self._aliases: dict[str, str] = {}

    def register(self, cmd: ToolCommand) -> None:
        # a user command must never shadow a built-in: the overwrite would
        # survive until the next reload, whose unregister_user_commands
        # then deletes the name entirely — the built-in is gone for the
        # life of the process
        existing = self._commands.get(cmd.name)
        if (
            getattr(cmd, "is_user_command", False)
            and existing is not None
            and not getattr(existing, "is_user_command", False)
        ):
            raise ValueError(
                f"command name '/{cmd.name}' collides with a built-in"
            )
        self._commands[cmd.name] = cmd
        for alias in cmd.aliases:
            # get() resolves aliases BEFORE command names, so an alias that
            # equals a built-in command NAME hijacks that built-in just as
            # surely as an alias→alias collision — check both tables.
            target = self._commands.get(self._aliases.get(alias, ""), None)
            shadowed = self._commands.get(alias)
            if getattr(cmd, "is_user_command", False):
                for hit in (target, shadowed):
                    if hit is not None and not getattr(hit, "is_user_command", False):
                        raise ValueError(
                            f"alias '/{alias}' collides with built-in '/{hit.name}'"
                        )
            self._aliases[alias] = cmd.name

    def unregister_user_commands(self) -> None:
        for name in [n for n, c in self._commands.items() if c.is_user_command]:
            cmd = self._commands.pop(name)
            for alias in cmd.aliases:
                self._aliases.pop(alias, None)

    def get(self, name: str) -> ToolCommand | None:
        return self._commands.get(self._aliases.get(name, name))

    def list_commands(self) -> list[dict]:
        return [
            {
                "name": c.name,
                "aliases": c.aliases,
                "description": c.description,
                "usage": c.usage,
            }
            for c in self._commands.values()
        ]


class HelpCommand(ToolCommand):
    name = "help"
    description = "List available commands"
    usage = "/help"

    def __init__(self, registry: CommandRegistry):
        self.registry = registry

    async def execute(self, args, context):
        lines = ["**Available commands**\n"]
        for c in self.registry.list_commands():
            alias = f" (aliases: {', '.join(c['aliases'])})" if c["aliases"] else ""
            lines.append(f"- `/{c['name']}`{alias} — {c['description']}")
        yield {"type": "token", "content": "\n".join(lines)}
        yield {"type": "done"}


class WebSearchCommand(ToolCommand):
    name = "web"
    description = "Web research: search, fetch, rerank, synthesize with citations"
    usage = "/web <query>"

    async def execute(self, args, context):
        from tensortruth_tpu_torch.web.pipeline import web_search_stream

        async for msg in web_search_stream(args, context):
            yield msg


def create_default_registry() -> CommandRegistry:
    registry = CommandRegistry()
    registry.register(HelpCommand(registry))
    registry.register(WebSearchCommand())
    return registry
