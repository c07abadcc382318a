"""Project routes (reference api/routes/projects.py:91-241)."""

from __future__ import annotations

from aiohttp import web

from tensortruth_tpu_torch.server.schemas import (
    CatalogModuleAddRequest,
    IndexingConfigUpdate,
    ProjectCreate,
    ProjectPatch,
    ProjectSessionCreate,
    parse_body,
)


def _svc(request):
    return request.app["services"].project_service


async def list_projects(request):
    return web.json_response({"projects": _svc(request).list_projects()})


async def create_project(request):
    body = await parse_body(request, ProjectCreate)
    project = _svc(request).create_project(
        name=body.name,
        description=body.description,
        modules=body.modules,
        system_prompt=body.system_prompt,
        params=body.params,
    )
    return web.json_response(project)


async def get_project(request):
    p = _svc(request).get_project(request.match_info["project_id"])
    if p is None:
        raise web.HTTPNotFound(reason="project not found")
    return web.json_response(p)


async def patch_project(request):
    patch = (await parse_body(request, ProjectPatch)).model_dump(exclude_unset=True)
    p = _svc(request).update_project(request.match_info["project_id"], patch)
    if p is None:
        raise web.HTTPNotFound(reason="project not found")
    return web.json_response(p)


async def delete_project(request):
    if not _svc(request).delete_project(request.match_info["project_id"]):
        raise web.HTTPNotFound(reason="project not found")
    return web.json_response({"status": "deleted"})


async def create_project_session(request):
    """Session inside a project inherits modules/params/system prompt
    (reference projects.py:183-218)."""
    services = request.app["services"]
    project_id = request.match_info["project_id"]
    ctx = _svc(request).session_context(project_id)
    if _svc(request).get_project(project_id) is None:
        raise web.HTTPNotFound(reason="project not found")
    body = await parse_body(request, ProjectSessionCreate)
    session = services.session_service.create_session(
        modules=body.modules if body.modules is not None else ctx["modules"],
        params={**ctx["params"], **body.params},
        title=body.title,
        project_id=project_id,
    )
    return web.json_response(session)


async def list_project_sessions(request):
    services = request.app["services"]
    project_id = request.match_info["project_id"]
    sessions = [
        s for s in services.session_service.list_sessions()
        if s.get("project_id") == project_id
    ]
    return web.json_response({"sessions": sessions})


async def add_catalog_module(request):
    """Attach a built catalog index to a project (reference
    documents.py:866-922): 400 when no built index exists, 409 when the
    module is already attached or building."""
    services = request.app["services"]
    body = await parse_body(request, CatalogModuleAddRequest)

    from tensortruth_tpu_torch.app.paths import get_base_indexes_dir
    from tensortruth_tpu_torch.indexing.metadata import list_modules_for_model

    model = services.config.rag.default_embedding_model
    built = list_modules_for_model(get_base_indexes_dir(), model)
    if body.module_name not in built:
        raise web.HTTPBadRequest(
            reason=f"Module '{body.module_name}' not found. No built index exists."
        )
    try:
        result = _svc(request).attach_catalog_module(
            request.match_info["project_id"], body.module_name
        )
    except KeyError:
        raise web.HTTPNotFound(reason="project not found")
    except ValueError as e:
        raise web.HTTPConflict(reason=str(e))
    return web.json_response(result, status=201)


async def remove_catalog_module(request):
    try:
        result = _svc(request).detach_catalog_module(
            request.match_info["project_id"], request.match_info["module_name"]
        )
    except KeyError as e:
        raise web.HTTPNotFound(reason=f"not found: {e}")
    except ValueError as e:
        raise web.HTTPConflict(reason=str(e))
    return web.json_response(result)


async def get_indexing_config(request):
    cfg = _svc(request).get_indexing_config(request.match_info["project_id"])
    if cfg is None:
        raise web.HTTPNotFound(reason="project not found")
    return web.json_response(cfg)


async def patch_indexing_config(request):
    """Update per-project chunk sizes / conversion method; a real change
    drops the existing scope index so the next build is a full rebuild
    (reference documents.py:687-740)."""
    body = await parse_body(request, IndexingConfigUpdate)
    if body.conversion_method is not None and body.conversion_method not in (
        "marker",
        "direct",
    ):
        raise web.HTTPBadRequest(
            reason="conversion_method must be 'marker' or 'direct'"
        )
    project_id = request.match_info["project_id"]
    result = _svc(request).update_indexing_config(
        project_id, body.model_dump(exclude_unset=True)
    )
    if result is None:
        raise web.HTTPNotFound(reason="project not found")
    if result["changed"]:
        from tensortruth_tpu_torch.app.paths import get_project_dir

        services = request.app["services"]
        doc_svc = services.document_service
        scope = get_project_dir(project_id)
        if doc_svc.index_exists(scope):
            doc_svc.delete_index(scope)
    return web.json_response(result["config"])


def setup(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/projects", list_projects)
    r.add_post("/api/projects", create_project)
    r.add_post("/api/projects/{project_id}/sessions", create_project_session)
    r.add_get("/api/projects/{project_id}/sessions", list_project_sessions)
    r.add_post("/api/projects/{project_id}/catalog-modules", add_catalog_module)
    r.add_delete(
        "/api/projects/{project_id}/catalog-modules/{module_name}",
        remove_catalog_module,
    )
    r.add_get("/api/projects/{project_id}/indexing-config", get_indexing_config)
    r.add_patch("/api/projects/{project_id}/indexing-config", patch_indexing_config)
    r.add_get("/api/projects/{project_id}", get_project)
    r.add_patch("/api/projects/{project_id}", patch_project)
    r.add_delete("/api/projects/{project_id}", delete_project)
