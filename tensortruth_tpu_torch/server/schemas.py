"""Typed request schemas for the REST surface.

Mirror of the reference's pydantic schema layer (reference api/schemas/*,
1,153 LoC across 13 modules). The reference gets validation for free from
FastAPI; aiohttp does not validate, so ``parse_body(request, Model)``
applies the same contract explicitly: invalid payloads return 422 with a
FastAPI-shaped ``{"detail": [{loc, msg, type}]}`` body, malformed JSON
returns 400.
"""

from __future__ import annotations

import json
from typing import Any, Literal

from aiohttp import web
from pydantic import BaseModel, ConfigDict, Field, ValidationError


class APIModel(BaseModel):
    """Ignore unknown fields (the reference's schemas are non-strict too)."""

    model_config = ConfigDict(extra="ignore")


# -- sessions (reference api/schemas/session.py) --------------------------------


class SessionCreate(APIModel):
    title: str = "New Session"
    modules: list[str] | None = None
    params: dict[str, Any] | None = None
    project_id: str | None = None


class SessionPatch(APIModel):
    title: str | None = None
    modules: list[str] | None = None
    params: dict[str, Any] | None = None
    project_id: str | None = None


class MessageCreate(APIModel):
    role: Literal["user", "assistant", "system"] = "user"
    content: str = ""
    sources: list[dict] | None = None
    metrics: dict | None = None


# -- projects (reference api/schemas/project.py) --------------------------------


class ProjectCreate(APIModel):
    name: str = Field(min_length=1, max_length=200)
    description: str = ""
    modules: list[str] | None = None
    system_prompt: str = ""
    params: dict[str, Any] | None = None


class ProjectPatch(APIModel):
    name: str | None = Field(default=None, min_length=1, max_length=200)
    description: str | None = None
    modules: list[str] | None = None
    system_prompt: str | None = None
    params: dict[str, Any] | None = None


class ProjectSessionCreate(APIModel):
    title: str = "New Session"
    modules: list[str] | None = None
    params: dict[str, Any] = Field(default_factory=dict)


# -- providers (reference api/schemas/provider.py) ------------------------------


class ProviderCreate(APIModel):
    id: str = Field(min_length=1, max_length=64)
    type: Literal["ollama", "openai_compatible", "llama_cpp"] = "ollama"
    base_url: str = ""
    api_key: str = ""
    enabled: bool = True
    models: list[str] = Field(default_factory=list)
    # full ProviderConfig surface (app/config.py) — extra="ignore" would
    # otherwise silently drop these on create/patch
    timeout: int = Field(default=300, ge=1, le=3600)
    default_capabilities: list[str] = Field(default_factory=list)


class ProviderPatch(APIModel):
    type: Literal["ollama", "openai_compatible", "llama_cpp"] | None = None
    base_url: str | None = None
    api_key: str | None = None
    enabled: bool | None = None
    models: list[str] | None = None
    timeout: int | None = Field(default=None, ge=1, le=3600)
    default_capabilities: list[str] | None = None


class ProviderTest(APIModel):
    type: Literal["ollama", "openai_compatible", "llama_cpp"] = "ollama"
    base_url: str = ""
    api_key: str = ""


# -- rerankers / models ----------------------------------------------------------


class RerankerAdd(APIModel):
    model_id: str = Field(min_length=1, max_length=200)
    local_dir: str | None = None


# -- documents (reference api/schemas/document.py) -------------------------------


class DocumentIngest(APIModel):
    url: str | None = None
    text: str | None = None
    filename: str = "pasted.md"
    arxiv_id: str | None = None


class TextUploadRequest(APIModel):
    """reference api/routes/documents.py upload-text body."""

    content: str = Field(min_length=1)
    filename: str = "pasted.md"


class UrlUploadRequest(APIModel):
    url: str = Field(min_length=1)
    context: str | None = None


class ArxivUploadRequest(APIModel):
    arxiv_id: str = Field(min_length=1, max_length=64)


class FileUrlUploadRequest(APIModel):
    url: str = Field(min_length=1)


class CatalogModuleAddRequest(APIModel):
    """reference api/routes/documents.py:866 CatalogModuleAddRequest."""

    module_name: str = Field(min_length=1, max_length=200)


class IndexingConfigUpdate(APIModel):
    """reference api/routes/documents.py:687 IndexingConfigUpdate."""

    chunk_sizes: list[int] | None = None
    conversion_method: str | None = None


# -- MCP servers -----------------------------------------------------------------


MCPTransport = Literal["stdio", "sse", "http", "streamable-http", "streamable_http"]


class MCPServerCreate(APIModel):
    name: str = Field(min_length=1, max_length=64)
    transport: MCPTransport = "stdio"
    command: str = ""
    args: list[str] = Field(default_factory=list)
    env: dict[str, str] = Field(default_factory=dict)
    headers: dict[str, str] = Field(default_factory=dict)
    url: str = ""
    enabled: bool = True


class MCPServerPatch(APIModel):
    transport: MCPTransport | None = None
    command: str | None = None
    args: list[str] | None = None
    env: dict[str, str] | None = None
    headers: dict[str, str] | None = None
    url: str | None = None
    enabled: bool | None = None


# -- extensions -------------------------------------------------------------------


class ExtensionInstall(APIModel):
    catalog_name: str | None = None
    ext_type: Literal["commands", "agents"] = "commands"
    filename: str = ""
    content: str = ""


# -- chat (REST; the WS path validates inline) ------------------------------------


class ChatRequest(APIModel):
    message: str = Field(min_length=1)
    params: dict[str, Any] | None = None


# -- config patch: free-form but must be a plain object of known sections ---------

KNOWN_CONFIG_SECTIONS = {
    "ollama", "llm", "rag", "conversation", "agent",
    "history_cleaning", "web_search", "providers",
    # top-level scalar the console round-trips via GET /api/config
    # (app/config.py to_dict)
    "extension_catalog_url",
}


def validate_config_patch(patch: Any) -> dict:
    if not isinstance(patch, dict):
        raise web.HTTPUnprocessableEntity(
            text=json.dumps(
                {"detail": [{"loc": ["body"], "msg": "patch must be an object",
                             "type": "type_error"}]}
            ),
            content_type="application/json",
        )
    unknown = set(patch) - KNOWN_CONFIG_SECTIONS
    if unknown:
        raise web.HTTPUnprocessableEntity(
            text=json.dumps(
                {"detail": [{"loc": ["body", k], "msg": "unknown config section",
                             "type": "value_error"} for k in sorted(unknown)]}
            ),
            content_type="application/json",
        )
    return patch


# -- the validation entrypoint -----------------------------------------------------


async def read_json(request: web.Request) -> Any:
    """Body → JSON, or 400 with a clear message (not a 500)."""
    if not request.can_read_body:
        return {}
    try:
        return await request.json()
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise web.HTTPBadRequest(
            text=json.dumps({"detail": f"malformed JSON body: {e}"}),
            content_type="application/json",
        )


async def parse_body(request: web.Request, model: type[APIModel]):
    """Validate the JSON body against ``model``; 422 on contract violation."""
    data = await read_json(request)
    if not isinstance(data, dict):
        raise web.HTTPUnprocessableEntity(
            text=json.dumps(
                {"detail": [{"loc": ["body"], "msg": "body must be a JSON object",
                             "type": "type_error"}]}
            ),
            content_type="application/json",
        )
    try:
        return model.model_validate(data)
    except ValidationError as e:
        detail = [
            {"loc": ["body", *err["loc"]], "msg": err["msg"], "type": err["type"]}
            for err in e.errors(include_url=False)
        ]
        raise web.HTTPUnprocessableEntity(
            text=json.dumps({"detail": detail}, default=str),
            content_type="application/json",
        )
