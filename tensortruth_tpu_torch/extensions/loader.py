"""User-extension loader: scan, validate, register; install/uninstall.

Mirrors reference extensions/loader.py:57-209 + extension_library services:
YAML files from ``~/.tensortruth_tpu/{commands,agents}/`` are parsed into
CommandSpec/AgentSpec and registered into the CommandRegistry/agent
registry; errors are accumulated, never fatal. The remote catalog fetch
(reference extension_catalog.py) degrades to the bundled catalog offline.
"""

from __future__ import annotations

import logging
from pathlib import Path

from tensortruth_tpu_torch.extensions.schema import AgentSpec, CommandSpec, ExtensionError

logger = logging.getLogger(__name__)

BUNDLED_LIBRARY = Path(__file__).resolve().parent.parent.parent / "extension_library"


def _bundled_catalog() -> list[dict]:
    import json

    catalog_file = BUNDLED_LIBRARY / "catalog.json"
    if catalog_file.exists():
        return json.loads(catalog_file.read_text())
    return []


def _ext_dirs() -> dict[str, Path]:
    from tensortruth_tpu_torch.app.paths import get_user_data_dir

    base = get_user_data_dir()
    return {"commands": base / "commands", "agents": base / "agents"}


def list_installed_extensions() -> list[dict]:
    out = []
    for ext_type, d in _ext_dirs().items():
        if not d.exists():
            continue
        for f in sorted(d.glob("*.yaml")) + sorted(d.glob("*.yml")):
            out.append({"ext_type": ext_type, "filename": f.name, "path": str(f)})
    return out


def load_user_extensions(services) -> dict:
    """Register every valid YAML extension; returns {loaded, errors}."""
    import yaml

    from tensortruth_tpu_torch.extensions.yaml_command import YamlCommand

    loaded, errors = [], []
    registry = services.command_registry
    registry.unregister_user_commands()
    dirs = _ext_dirs()

    for f in sorted(dirs["commands"].glob("*.y*ml")) if dirs["commands"].exists() else []:
        try:
            spec = CommandSpec.from_dict(yaml.safe_load(f.read_text()) or {})
            registry.register(YamlCommand(spec, services.tool_service))
            loaded.append(f"commands/{f.name}")
        except (ExtensionError, yaml.YAMLError, OSError, ValueError) as e:
            errors.append({"file": f.name, "error": str(e)})

    from tensortruth_tpu_torch.agents.registry import AgentFactoryRegistry

    agent_registry = AgentFactoryRegistry.get_instance()
    agent_registry.clear_user_agents()
    for f in sorted(dirs["agents"].glob("*.y*ml")) if dirs["agents"].exists() else []:
        try:
            spec = AgentSpec.from_dict(yaml.safe_load(f.read_text()) or {})
            agent_registry.register_yaml_agent(spec)
            loaded.append(f"agents/{f.name}")
        except (ExtensionError, yaml.YAMLError, OSError) as e:
            errors.append({"file": f.name, "error": str(e)})

    if errors:
        logger.warning("extension errors: %s", errors)
    return {"loaded": loaded, "errors": errors}


def install_extension(ext_type: str, filename: str, content: str, services=None) -> dict:
    import yaml

    if ext_type not in ("commands", "agents"):
        raise ValueError(f"invalid ext_type: {ext_type}")
    if not filename.endswith((".yaml", ".yml")) or "/" in filename or ".." in filename:
        raise ValueError("filename must be a bare .yaml name")
    data = yaml.safe_load(content) or {}
    # Validate before writing.
    (CommandSpec if ext_type == "commands" else AgentSpec).from_dict(data)
    d = _ext_dirs()[ext_type]
    d.mkdir(parents=True, exist_ok=True)
    (d / filename).write_text(content)
    if services is not None:
        load_user_extensions(services)
    return {"status": "installed", "ext_type": ext_type, "filename": filename}


def uninstall_extension(ext_type: str, filename: str, services=None) -> bool:
    if ext_type not in ("commands", "agents") or "/" in filename or ".." in filename:
        return False
    f = _ext_dirs()[ext_type] / filename
    if not f.exists():
        return False
    f.unlink()
    if services is not None:
        load_user_extensions(services)
    return True


def get_extension_catalog(config=None) -> list[dict]:
    """Remote catalog (reference extension_catalog.py) with the bundled
    extension_library/ as offline fallback."""
    url = getattr(config, "extension_catalog_url", "") if config else ""
    if url:
        try:
            import requests

            r = requests.get(f"{url}/catalog.json", timeout=10)
            r.raise_for_status()
            return r.json()
        except Exception as e:
            logger.warning("catalog fetch failed (%s); using bundled", e)
    return _bundled_catalog()


def install_from_catalog(name: str, services=None) -> dict:
    """Install a bundled extension_library entry by name
    (reference extension_library_service.py)."""
    entry = next((e for e in _bundled_catalog() if e["name"] == name), None)
    if entry is None:
        raise ValueError(f"unknown catalog extension: {name}")
    src = BUNDLED_LIBRARY / entry["ext_type"] / entry["filename"]
    if not src.exists():
        raise ValueError(f"catalog file missing: {src}")
    return install_extension(
        entry["ext_type"], entry["filename"], src.read_text(), services=services
    )
