"""Document upload/ingestion routes for session + project scopes.

Mirrors reference api/routes/documents.py:402-959 (upload/url/text per
scope, list, delete, reindex) and pdfs.py legacy endpoints.
"""

from __future__ import annotations

import asyncio

from aiohttp import web

from tensortruth_tpu_torch.app.paths import get_project_dir, get_session_dir


def _scope_dir(request) -> str:
    if "session_id" in request.match_info:
        return get_session_dir(request.match_info["session_id"])
    return get_project_dir(request.match_info["project_id"])


async def upload_document(request: web.Request):
    """multipart PDF/text upload OR JSON {filename, text|url}."""
    services = request.app["services"]
    scope = _scope_dir(request)
    doc_svc = services.document_service
    loop = asyncio.get_running_loop()

    ctype = request.content_type or ""
    if ctype.startswith("multipart/"):
        reader = await request.multipart()
        part = await reader.next()
        while part is not None and part.name != "file":
            part = await reader.next()
        if part is None:
            raise web.HTTPUnprocessableEntity(reason="missing 'file' part")
        filename = part.filename or "upload.pdf"
        data = await part.read()
        if filename.lower().endswith(".pdf"):
            result = await loop.run_in_executor(
                None, doc_svc.add_pdf, scope, filename, data
            )
        else:
            result = await loop.run_in_executor(
                None, doc_svc.add_text, scope, filename, data.decode("utf-8", "ignore")
            )
    else:
        from tensortruth_tpu_torch.server.schemas import DocumentIngest, parse_body

        body = await parse_body(request, DocumentIngest)
        if body.url:
            result = await loop.run_in_executor(
                None, doc_svc.add_url, scope, body.url
            )
        elif body.text is not None:
            result = await loop.run_in_executor(
                None, doc_svc.add_text, scope, body.filename, body.text,
            )
        else:
            raise web.HTTPUnprocessableEntity(reason="provide file, url, or text")
    status = 200 if result.get("status") == "success" else 422
    return web.json_response(result, status=status)


async def list_documents(request: web.Request):
    services = request.app["services"]
    details = services.document_service.describe_documents(_scope_dir(request))
    # ``documents`` carries id+filename+chunks objects (reference
    # PDFListResponse); ``ids`` keeps the flat list for scripted clients.
    return web.json_response(
        {"documents": details, "ids": [d["id"] for d in details]}
    )


async def delete_document(request: web.Request):
    services = request.app["services"]
    # executor like every other heavy handler here: a tombstone delete can
    # trigger a compaction (re-save of the full matrix) — not event-loop work
    removed = await asyncio.get_running_loop().run_in_executor(
        None,
        services.document_service.remove_document,
        _scope_dir(request),
        request.match_info["doc_id"],
    )
    if removed == 0:
        raise web.HTTPNotFound(reason="document not found")
    return web.json_response({"status": "deleted", "chunks_removed": removed})


async def reindex(request: web.Request):
    services = request.app["services"]
    loop = asyncio.get_running_loop()
    n = await loop.run_in_executor(
        None, services.document_service.reindex, _scope_dir(request)
    )
    return web.json_response({"status": "reindexed", "documents": n})


async def file_url_info(request: web.Request):
    """Probe a URL before ingestion: content type + suggested handler
    (reference documents.py:402)."""
    url = request.query.get("url", "")
    if not url:
        raise web.HTTPUnprocessableEntity(reason="url query param required")
    from tensortruth_tpu_torch.web.fetch import _HANDLERS

    handler = next((type(h).__name__ for h in _HANDLERS if h.matches(url)), None)
    info = {"url": url, "handler": handler, "content_type": None}
    try:
        import asyncio

        import requests

        def probe():
            r = requests.head(url, timeout=10, allow_redirects=True)
            return r.headers.get("Content-Type", "")

        info["content_type"] = await asyncio.to_thread(probe)
    except Exception as e:
        info["error"] = str(e)
    return web.json_response(info)


async def upload_pdf_strict(request: web.Request):
    """reference documents.py upload: multipart, PDF only, 201."""
    services = request.app["services"]
    scope = _scope_dir(request)
    reader = await request.multipart()
    part = await reader.next()
    while part is not None and part.name != "file":
        part = await reader.next()
    if part is None:
        raise web.HTTPUnprocessableEntity(reason="missing 'file' part")
    filename = part.filename or ""
    if not filename.lower().endswith(".pdf"):
        raise web.HTTPBadRequest(reason="File must be a PDF")
    data = await part.read()
    result = await asyncio.get_running_loop().run_in_executor(
        None, services.document_service.add_pdf, scope, filename, data
    )
    status = 201 if result.get("status") == "success" else 422
    return web.json_response(result, status=status)


async def upload_text(request: web.Request):
    from tensortruth_tpu_torch.server.schemas import TextUploadRequest, parse_body

    body = await parse_body(request, TextUploadRequest)
    services = request.app["services"]
    result = await asyncio.get_running_loop().run_in_executor(
        None,
        services.document_service.add_text,
        _scope_dir(request),
        body.filename,
        body.content,
    )
    status = 201 if result.get("status") == "success" else 422
    return web.json_response(result, status=status)


async def upload_url(request: web.Request):
    from tensortruth_tpu_torch.server.schemas import UrlUploadRequest, parse_body

    body = await parse_body(request, UrlUploadRequest)
    services = request.app["services"]
    meta = {"context": body.context} if body.context else None
    result = await asyncio.get_running_loop().run_in_executor(
        None, services.document_service.add_url, _scope_dir(request), body.url, meta
    )
    status = 201 if result.get("status") == "success" else 400
    return web.json_response(result, status=status)


async def upload_arxiv(request: web.Request):
    from tensortruth_tpu_torch.server.schemas import ArxivUploadRequest, parse_body

    body = await parse_body(request, ArxivUploadRequest)
    services = request.app["services"]
    result = await asyncio.get_running_loop().run_in_executor(
        None, services.document_service.add_arxiv, _scope_dir(request), body.arxiv_id
    )
    status = 201 if result.get("status") == "success" else 400
    return web.json_response(result, status=status)


async def upload_file_url(request: web.Request):
    from tensortruth_tpu_torch.server.schemas import FileUrlUploadRequest, parse_body

    body = await parse_body(request, FileUrlUploadRequest)
    services = request.app["services"]
    result = await asyncio.get_running_loop().run_in_executor(
        None, services.document_service.add_file_url, _scope_dir(request), body.url
    )
    status = 201 if result.get("status") == "success" else 400
    return web.json_response(result, status=status)


async def build_index(request: web.Request):
    """Submit the scope rebuild to the serial TaskRunner and return the
    task id (reference documents.py build-index → ReindexTaskResponse);
    progress is pollable at /api/tasks/{task_id}."""
    services = request.app["services"]
    scope = _scope_dir(request)
    doc_svc = services.document_service

    def job(progress):
        progress("indexing", 0, 1)
        n = doc_svc.reindex(scope)
        progress("indexing", 1, 1)
        return {"documents": n}

    info = services.task_runner.submit("build-index", job)
    return web.json_response({"task_id": info.id, "status": "started"})


def setup(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/file-url-info", file_url_info)
    for scope in ("sessions/{session_id}", "projects/{project_id}"):
        r.add_get(f"/api/{scope}/documents", list_documents)
        r.add_post(f"/api/{scope}/documents", upload_document)
        r.add_post(f"/api/{scope}/documents/reindex", reindex)
        # Reference-named subroutes (api/routes/documents.py:527-862): the
        # reference frontend and scripted clients address these exact paths.
        r.add_post(f"/api/{scope}/documents/upload", upload_pdf_strict)
        r.add_post(f"/api/{scope}/documents/upload-text", upload_text)
        r.add_post(f"/api/{scope}/documents/upload-url", upload_url)
        r.add_post(f"/api/{scope}/documents/upload-arxiv", upload_arxiv)
        r.add_post(f"/api/{scope}/documents/upload-file-url", upload_file_url)
        r.add_post(f"/api/{scope}/documents/build-index", build_index)
        r.add_delete(f"/api/{scope}/documents/{{doc_id}}", delete_document)
    # Legacy pdf endpoints (reference api/routes/pdfs.py:15-102)
    r.add_get("/api/sessions/{session_id}/pdfs", list_documents)
    r.add_post("/api/sessions/{session_id}/pdfs", upload_pdf_strict)
    r.add_post("/api/sessions/{session_id}/pdfs/reindex", reindex)
    r.add_delete("/api/sessions/{session_id}/pdfs/{doc_id}", delete_document)
