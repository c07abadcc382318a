"""Project persistence + config inheritance to sessions.

Behavioral mirror of reference services/project_service.py:22-307: project
CRUD under ``projects/{id}/project.json``, catalog-module attach/detach,
system-prompt + param inheritance for sessions created inside a project.
"""

from __future__ import annotations

import uuid
from datetime import datetime, timezone
from pathlib import Path

from tensortruth_tpu_torch.app.file_utils import atomic_write_json, read_json


def _now() -> str:
    return datetime.now(timezone.utc).isoformat()


class ProjectService:
    def __init__(self, projects_dir: str | Path):
        self.projects_dir = Path(projects_dir)
        self.projects_dir.mkdir(parents=True, exist_ok=True)

    def _file(self, project_id: str) -> Path:
        return self.projects_dir / project_id / "project.json"

    def create_project(
        self,
        name: str,
        description: str = "",
        modules: list[str] | None = None,
        system_prompt: str = "",
        params: dict | None = None,
    ) -> dict:
        project_id = uuid.uuid4().hex[:12]
        project = {
            "id": project_id,
            "name": name,
            "description": description,
            "created_at": _now(),
            "updated_at": _now(),
            "modules": modules or [],
            "system_prompt": system_prompt,
            "params": params or {},
            "documents": [],
            "catalog_modules": {},
            "config": {},
        }
        (self.projects_dir / project_id).mkdir(parents=True, exist_ok=True)
        atomic_write_json(self._file(project_id), project)
        return project

    def get_project(self, project_id: str) -> dict | None:
        return read_json(self._file(project_id))

    def list_projects(self) -> list[dict]:
        out = []
        for d in sorted(self.projects_dir.iterdir()) if self.projects_dir.exists() else []:
            if d.is_dir():
                p = read_json(d / "project.json")
                if p:
                    out.append(p)
        out.sort(key=lambda p: p.get("created_at", ""), reverse=True)
        return out

    def update_project(self, project_id: str, patch: dict) -> dict | None:
        project = self.get_project(project_id)
        if project is None:
            return None
        for key in ("name", "description", "modules", "system_prompt", "params", "documents"):
            if key in patch:
                project[key] = patch[key]
        project["updated_at"] = _now()
        atomic_write_json(self._file(project_id), project)
        return project

    def delete_project(self, project_id: str) -> bool:
        import shutil

        d = self.projects_dir / project_id
        if not d.exists():
            return False
        shutil.rmtree(d)
        return True

    def session_context(self, project_id: str) -> dict:
        """Modules + params + system prompt a session inherits
        (reference chat.py:119-215 ChatContext.from_session — project
        catalog modules merge into the session's module set)."""
        project = self.get_project(project_id)
        if project is None:
            return {"modules": [], "params": {}, "system_prompt": ""}
        modules = list(project.get("modules", []))
        for name, entry in project.get("catalog_modules", {}).items():
            status = entry.get("status") if isinstance(entry, dict) else entry
            if status == "indexed" and name not in modules:
                modules.append(name)
        return {
            "modules": modules,
            "params": dict(project.get("params", {})),
            "system_prompt": project.get("system_prompt", ""),
        }

    # -- catalog modules (reference api/routes/documents.py:866-959) --------

    def attach_catalog_module(self, project_id: str, module_name: str) -> dict:
        """Attach a built catalog index to the project.

        Returns {"status": ...}; raises KeyError when the project is
        missing and ValueError on attach conflicts (already indexed /
        building) — the route maps those to 404/409.
        """
        project = self.get_project(project_id)
        if project is None:
            raise KeyError(project_id)
        catalog = project.setdefault("catalog_modules", {})
        existing = catalog.get(module_name)
        if isinstance(existing, dict) and existing.get("status") in (
            "building",
            "indexed",
        ):
            raise ValueError(
                f"module '{module_name}' is already {existing['status']}"
            )
        catalog[module_name] = {"status": "indexed"}
        project["updated_at"] = _now()
        atomic_write_json(self._file(project_id), project)
        return {"module_name": module_name, "status": "indexed"}

    def detach_catalog_module(self, project_id: str, module_name: str) -> dict:
        project = self.get_project(project_id)
        if project is None:
            raise KeyError(project_id)
        catalog = project.get("catalog_modules", {})
        if module_name not in catalog:
            raise KeyError(module_name)
        entry = catalog[module_name]
        if isinstance(entry, dict) and entry.get("status") == "building":
            raise ValueError(f"module '{module_name}' is being built")
        del catalog[module_name]
        project["updated_at"] = _now()
        atomic_write_json(self._file(project_id), project)
        return {"module_name": module_name, "status": "removed"}

    # -- indexing config (reference api/routes/documents.py:674-740) --------

    def get_indexing_config(self, project_id: str) -> dict | None:
        project = self.get_project(project_id)
        if project is None:
            return None
        return dict(project.get("config", {}).get("indexing", {}))

    def update_indexing_config(self, project_id: str, patch: dict) -> dict | None:
        """Merge {chunk_sizes, conversion_method} into the project's
        indexing config. Returns (new_config, settings_changed) — the
        route deletes the scope index when settings actually changed."""
        project = self.get_project(project_id)
        if project is None:
            return None
        indexing = project.setdefault("config", {}).setdefault("indexing", {})
        before = dict(indexing)
        for key in ("chunk_sizes", "conversion_method"):
            if patch.get(key) is not None:
                indexing[key] = patch[key]
        project["updated_at"] = _now()
        atomic_write_json(self._file(project_id), project)
        return {"config": dict(indexing), "changed": indexing != before}
