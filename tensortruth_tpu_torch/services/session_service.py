"""Session persistence: per-session files + index cache.

Behavioral mirror of reference services/session_service.py:25-609:
per-session ``sessions/{id}/session.json`` (authoritative) + a
``sessions_index.json`` cache for fast listing, atomic writes,
config-default param filling, CRUD/messages/title.
"""

from __future__ import annotations

import logging
import uuid
from datetime import datetime, timezone
from pathlib import Path

from tensortruth_tpu_torch.app.file_utils import atomic_write_json, read_json

logger = logging.getLogger(__name__)


def _now() -> str:
    return datetime.now(timezone.utc).isoformat()


class SessionService:
    def __init__(self, sessions_dir: str | Path, config=None):
        self.sessions_dir = Path(sessions_dir)
        self.sessions_dir.mkdir(parents=True, exist_ok=True)
        self.index_file = self.sessions_dir / "sessions_index.json"
        self.config = config

    # -- defaults (reference session_service.py:52-98) ------------------------

    def apply_config_defaults(self, params: dict) -> dict:
        if self.config is None:
            return dict(params)
        c = self.config
        defaults = {
            "model": c.llm.default_model,
            "temperature": c.llm.default_temperature,
            "context_window": c.llm.default_context_window,
            "max_tokens": c.llm.default_max_tokens,
            "reranker_model": c.rag.default_reranker,
            "reranker_top_n": c.rag.default_top_n,
            "confidence_cutoff": c.rag.default_confidence_threshold,
            "confidence_cutoff_hard": c.rag.default_confidence_cutoff_hard,
            "rag_device": c.rag.default_device,
            "balance_strategy": c.rag.default_balance_strategy,
            "embedding_model": c.rag.default_embedding_model,
            "orchestrator_enabled": c.agent.orchestrator_enabled,
            "max_history_turns": c.conversation.max_history_turns,
        }
        # explicit nulls in the request body must not shadow defaults with
        # None (a None confidence_cutoff later crashes the gate compare)
        return {**defaults, **{k: v for k, v in params.items() if v is not None}}

    # -- index cache -----------------------------------------------------------

    def _load_index(self) -> dict:
        return read_json(self.index_file, {"current_id": None, "sessions": {}})

    def _save_index(self, index: dict) -> None:
        atomic_write_json(self.index_file, index)

    def _session_file(self, session_id: str) -> Path:
        return self.sessions_dir / session_id / "session.json"

    # -- CRUD -------------------------------------------------------------------

    def create_session(
        self,
        modules: list[str] | None = None,
        params: dict | None = None,
        title: str = "New Session",
        project_id: str | None = None,
    ) -> dict:
        session_id = uuid.uuid4().hex[:12]
        session = {
            "id": session_id,
            "title": title,
            "created_at": _now(),
            "updated_at": _now(),
            "messages": [],
            "modules": modules or [],
            "params": self.apply_config_defaults(params or {}),
            "project_id": project_id,
            "title_needs_update": True,
        }
        (self.sessions_dir / session_id).mkdir(parents=True, exist_ok=True)
        atomic_write_json(self._session_file(session_id), session)
        index = self._load_index()
        index["sessions"][session_id] = {
            "title": title,
            "created_at": session["created_at"],
            "project_id": project_id,
        }
        index["current_id"] = session_id
        self._save_index(index)
        return session

    def get_session(self, session_id: str) -> dict | None:
        return read_json(self._session_file(session_id))

    def list_sessions(self) -> list[dict]:
        index = self._load_index()
        return [
            {"id": sid, **meta}
            for sid, meta in sorted(
                index["sessions"].items(),
                key=lambda kv: kv[1].get("created_at", ""),
                reverse=True,
            )
        ]

    def save_session(self, session: dict) -> None:
        session["updated_at"] = _now()
        atomic_write_json(self._session_file(session["id"]), session)
        index = self._load_index()
        entry = index["sessions"].setdefault(session["id"], {})
        entry["title"] = session.get("title", "")
        entry["created_at"] = session.get("created_at", _now())
        entry["project_id"] = session.get("project_id")
        self._save_index(index)

    def delete_session(self, session_id: str) -> bool:
        import shutil

        d = self.sessions_dir / session_id
        existed = d.exists()
        if existed:
            shutil.rmtree(d)
        index = self._load_index()
        index["sessions"].pop(session_id, None)
        if index.get("current_id") == session_id:
            index["current_id"] = None
        self._save_index(index)
        return existed

    def update_session(self, session_id: str, patch: dict) -> dict | None:
        session = self.get_session(session_id)
        if session is None:
            return None
        for key in ("title", "modules", "params", "project_id", "title_needs_update"):
            if key in patch:
                if key == "params":
                    # explicit null params = no-op merge, not a crash; a
                    # null VALUE deletes the key so clients can restore a
                    # param to "use config default" (merge alone could
                    # never un-set a previously saved value).
                    merged = dict(session.get("params", {}))
                    for pk, pv in (patch["params"] or {}).items():
                        if pv is None:
                            merged.pop(pk, None)
                        else:
                            merged[pk] = pv
                    session["params"] = merged
                else:
                    session[key] = patch[key]
        self.save_session(session)
        return session

    # -- messages ----------------------------------------------------------------

    def add_message(
        self,
        session_id: str,
        role: str,
        content: str,
        sources: list | None = None,
        metrics: dict | None = None,
        **extra,
    ) -> dict | None:
        session = self.get_session(session_id)
        if session is None:
            return None
        msg = {"role": role, "content": content, "timestamp": _now(), **extra}
        if sources is not None:
            msg["sources"] = sources
        if metrics is not None:
            msg["metrics"] = metrics
        session["messages"].append(msg)
        self.save_session(session)
        return msg

    def get_messages(self, session_id: str) -> list[dict]:
        session = self.get_session(session_id)
        return session["messages"] if session else []

    def set_title(self, session_id: str, title: str) -> None:
        self.update_session(session_id, {"title": title, "title_needs_update": False})

    # -- stats (reference routes/sessions.py:200) --------------------------------

    def stats(self) -> dict:
        sessions = self.list_sessions()
        n_msgs = 0
        for s in sessions:
            data = self.get_session(s["id"])
            if data:
                n_msgs += len(data.get("messages", []))
        return {"total_sessions": len(sessions), "total_messages": n_msgs}
