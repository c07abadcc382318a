"""MCP server config CRUD + toggle, persisted to JSON.

Mirrors reference services/mcp_server_service.py:1-382 (stdio/SSE server
configs, enable/disable, presets). Actually *connecting* to MCP servers is
handled by the orchestrator's tool loader; offline environments simply list
configs without live tools.
"""

from __future__ import annotations

from pathlib import Path

from tensortruth_tpu_torch.app.file_utils import atomic_write_json, read_json

PRESETS = [
    {
        "name": "web-tools",
        "description": "Built-in web search/fetch tools exposed over MCP stdio",
        "transport": "stdio",
        "command": "python",
        "args": ["-m", "tensortruth_tpu_torch.mcp_servers.web_tools_server"],
    },
]


class MCPServerService:
    def __init__(self, config_path: str | Path):
        self.config_path = Path(config_path)

    def _load(self) -> dict:
        return read_json(self.config_path, {"servers": {}})

    def _save(self, data: dict) -> None:
        atomic_write_json(self.config_path, data)

    def list_servers(self) -> list[dict]:
        return [
            {"name": name, **cfg} for name, cfg in self._load()["servers"].items()
        ]

    def get_presets(self) -> list[dict]:
        return list(PRESETS)

    def add_server(self, name: str, config: dict) -> dict:
        data = self._load()
        if name in data["servers"]:
            raise ValueError(f"server '{name}' already exists")
        config = {"enabled": True, "transport": "stdio", **config}
        data["servers"][name] = config
        self._save(data)
        return {"name": name, **config}

    def update_server(self, name: str, patch: dict) -> dict | None:
        data = self._load()
        if name not in data["servers"]:
            return None
        data["servers"][name].update(patch)
        self._save(data)
        return {"name": name, **data["servers"][name]}

    def delete_server(self, name: str) -> bool:
        data = self._load()
        if name not in data["servers"]:
            return False
        del data["servers"][name]
        self._save(data)
        return True

    def toggle_server(self, name: str) -> dict | None:
        data = self._load()
        if name not in data["servers"]:
            return None
        cfg = data["servers"][name]
        cfg["enabled"] = not cfg.get("enabled", True)
        self._save(data)
        return {"name": name, **cfg}
