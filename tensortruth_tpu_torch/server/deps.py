"""Service container — the DI layer behind every route.

Mirrors reference api/deps.py:36-196 (lru_cache singletons + Annotated deps)
as one explicit container object stored on the aiohttp app.
"""

from __future__ import annotations

import logging
from pathlib import Path

logger = logging.getLogger(__name__)


class ServiceContainer:
    def __init__(self, data_dir: str | Path | None = None, config=None, device="cuda"):
        from tensortruth_tpu_torch.app import paths
        from tensortruth_tpu_torch.app.config import load_config

        if data_dir is not None:
            import os

            os.environ[paths.ENV_DATA_DIR] = str(data_dir)
        self.data_dir = paths.get_user_data_dir()
        self.config = config or load_config()
        self.device = device  # where the models and engines load
        self._rag_service = None
        self._session_service = None
        self._project_service = None
        self._document_service = None
        self._task_runner = None
        self._command_registry = None
        self._tool_service = None
        self._extension_loader = None
        self._mcp_service = None
        self._confirmation_service = None

    # -- config ------------------------------------------------------------

    def reload_config(self):
        from tensortruth_tpu_torch.app.config import load_config

        self.config = load_config()
        self.rebind_config()
        return self.config

    def rebind_config(self) -> None:
        """Point already-built singletons at the current config object.

        Services capture ``config`` at construction; after a PATCH
        /api/config only the container's reference changed, so new sessions
        kept getting the OLD defaults (session_service) and engine hashing
        used stale model defaults (rag_service) until process restart."""
        for svc in (
            self._rag_service, self._session_service, self._tool_service,
        ):
            if svc is not None:
                svc.config = self.config
        if self._rag_service is not None:
            self._rag_service.chat_history_service.config = self.config

    def save_config(self):
        from tensortruth_tpu_torch.app.config import save_config

        save_config(self.config)

    # -- services (lazy singletons) -----------------------------------------

    @property
    def rag_service(self):
        if self._rag_service is None:
            from tensortruth_tpu_torch.services.rag_service import RAGService

            self._rag_service = RAGService(config=self.config, device=self.device)
        return self._rag_service

    @property
    def session_service(self):
        if self._session_service is None:
            from tensortruth_tpu_torch.app.paths import get_sessions_data_dir
            from tensortruth_tpu_torch.services.session_service import SessionService

            self._session_service = SessionService(
                get_sessions_data_dir(), config=self.config
            )
        return self._session_service

    @property
    def project_service(self):
        if self._project_service is None:
            from tensortruth_tpu_torch.app.paths import get_projects_data_dir
            from tensortruth_tpu_torch.services.project_service import ProjectService

            self._project_service = ProjectService(get_projects_data_dir())
        return self._project_service

    @property
    def document_service(self):
        if self._document_service is None:
            from tensortruth_tpu_torch.models.manager import ModelManager, ModelSpec
            from tensortruth_tpu_torch.services.document_service import DocumentService

            def embedder_factory():
                model = self.config.rag.default_embedding_model
                mc = self.config.rag.get_embedding_model_config(model)
                return ModelManager.get_instance().get_embedder(
                    ModelSpec(
                        model,
                        dtype=mc.dtype,
                        max_length=mc.max_length,
                        local_dir=mc.local_dir,
                        tokenizer_path=mc.tokenizer_path,
                        batch_buckets=tuple(mc.batch_buckets) if mc.batch_buckets else None,
                        seq_buckets=tuple(mc.seq_buckets) if mc.seq_buckets else None,
                    ),
                    device=self.device,
                )

            self._document_service = DocumentService(embedder_factory)
        return self._document_service

    @property
    def task_runner(self):
        if self._task_runner is None:
            from tensortruth_tpu_torch.services.task_runner import TaskRunner

            self._task_runner = TaskRunner()
            self._task_runner.start()
        return self._task_runner

    @property
    def command_registry(self):
        if self._command_registry is None:
            from tensortruth_tpu_torch.server.commands import create_default_registry

            self._command_registry = create_default_registry()
        return self._command_registry

    @property
    def tool_service(self):
        if self._tool_service is None:
            from tensortruth_tpu_torch.services.tool_service import ToolService

            self._tool_service = ToolService(self.config)
        return self._tool_service

    @property
    def mcp_service(self):
        if self._mcp_service is None:
            from tensortruth_tpu_torch.services.mcp_server_service import MCPServerService

            self._mcp_service = MCPServerService(self.data_dir / "mcp_servers.json")
        return self._mcp_service

    @property
    def confirmation_service(self):
        if self._confirmation_service is None:
            from tensortruth_tpu_torch.services.tool_confirmation_service import (
                ToolConfirmationService,
            )

            self._confirmation_service = ToolConfirmationService()
        return self._confirmation_service

    # -- MCP tools (lazy connect, cached until config change) ------------------

    _mcp_tools_cache: tuple | None = None
    _mcp_load_lock = None  # asyncio.Lock, created lazily in a running loop

    async def get_mcp_tools(self) -> dict:
        """name→ToolSpec from enabled MCP servers (agents/mcp_client.py).

        Single-flighted: two cold WS chats racing here would BOTH connect
        every server (spawned stdio subprocesses / SSE sockets), and the
        loser's clients would be orphaned for the life of the process."""
        if self._mcp_tools_cache is None:
            import asyncio

            if self._mcp_load_lock is None:
                self._mcp_load_lock = asyncio.Lock()
            async with self._mcp_load_lock:
                if self._mcp_tools_cache is None:
                    from tensortruth_tpu_torch.agents.mcp_client import load_mcp_tools

                    self._mcp_tools_cache = await load_mcp_tools(self.mcp_service)
        return self._mcp_tools_cache[0]

    def mcp_connection_status(self) -> dict:
        """Last-known per-server connect status (empty until tools load).

        Pure read — listing servers must NOT trigger connections (a GET
        spawning subprocesses / opening sockets would be a surprise)."""
        return dict(self._mcp_tools_cache[2]) if self._mcp_tools_cache else {}

    async def invalidate_mcp_tools(self) -> None:
        if self._mcp_tools_cache is not None:
            for client in self._mcp_tools_cache[1]:
                try:
                    await client.close()
                except Exception:
                    pass
            self._mcp_tools_cache = None

    def shutdown(self):
        if self._task_runner is not None:
            self._task_runner.stop()
        if self._mcp_tools_cache is not None:
            import asyncio

            clients = self._mcp_tools_cache[1]
            self._mcp_tools_cache = None
            try:
                loop = asyncio.get_running_loop()
                for c in clients:
                    loop.create_task(c.close())
            except RuntimeError:
                pass
