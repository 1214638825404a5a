"""OpenAPI 3 schema for the serving API.

The reference exposes drf-spectacular's generated schema at /api/schema/
(+ swagger/redoc UIs, reference backend/project/urls.py:30-32); here the
schema is generated from the route table directly.
"""

from __future__ import annotations

_JOB_SCHEMA = {
    "type": "object",
    "properties": {
        "id": {"type": "string", "format": "uuid"},
        "vision_model": {"type": "integer"},
        "vision_model_details": {"$ref": "#/components/schemas/VisionModel"},
        "user_username": {"type": "string", "nullable": True},
        "status": {"type": "string",
                   "enum": ["PENDING", "PROCESSING", "DONE", "FAILED"]},
        "input_image": {"type": "string", "nullable": True},
        "mask_image": {"type": "string", "nullable": True},
        "error_message": {"type": "string"},
        "detections": {"type": "array", "items": {
            "type": "object",
            "properties": {"class_id": {"type": "integer"},
                           "box_yxyx": {"type": "array",
                                        "items": {"type": "integer"}}}}},
        "created_at": {"type": "string", "format": "date-time"},
        "updated_at": {"type": "string", "format": "date-time"},
    },
}

_MODEL_SCHEMA = {
    "type": "object",
    "properties": {
        "id": {"type": "integer"},
        "name": {"type": "string"},
        "description": {"type": "string"},
        "num_classes": {"type": "integer"},
        "input_size": {"type": "integer"},
        "config_name": {"type": "string"},
    },
}


def _paginated(ref: str) -> dict:
    return {"type": "object", "properties": {
        "count": {"type": "integer"},
        "next": {"type": "string", "nullable": True},
        "previous": {"type": "string", "nullable": True},
        "results": {"type": "array", "items": {"$ref": ref}},
    }}


def openapi_schema() -> dict:
    return {
        "openapi": "3.0.3",
        "info": {"title": "visiontransformer_tpu_torch serving API",
                 "version": "1.0.0",
                 "description": "GPU (PyTorch/CUDA) structural-damage inference "
                                "platform (reference-compatible contract)"},
        "paths": {
            "/api/csrf/": {"get": {"summary": "Set CSRF cookie",
                                   "responses": {"200": {"description": "ok"}}}},
            "/api/hello/": {"get": {"summary": "Health check",
                                    "responses": {"200": {"description": "ok"}}}},
            "/api/vision-models/": {"get": {
                "summary": "List vision models",
                "responses": {"200": {"description": "paginated models"}}}},
            "/api/vision-models/{id}/": {"get": {
                "summary": "Model detail",
                "parameters": [{"name": "id", "in": "path", "required": True,
                                "schema": {"type": "integer"}}],
                "responses": {"200": {"description": "model"},
                              "404": {"description": "not found"}}}},
            "/api/inference-jobs/": {
                "get": {"summary": "List own jobs",
                        "parameters": [
                            {"name": "status", "in": "query",
                             "schema": {"type": "string"}},
                            {"name": "page", "in": "query",
                             "schema": {"type": "integer"}}],
                        "responses": {"200": {"description": "paginated jobs"},
                                      "403": {"description": "auth required"}}},
                "post": {"summary": "Submit inference job (multipart)",
                         "responses": {"201": {"description": "job created"},
                                       "400": {"description": "bad request"}}}},
            "/api/inference-jobs/{id}/": {"get": {
                "summary": "Job detail",
                "parameters": [{"name": "id", "in": "path", "required": True,
                                "schema": {"type": "string"}},
                               {"name": "wait", "in": "query",
                                "description": "long-poll: block up to this "
                                               "many seconds for DONE/FAILED",
                                "schema": {"type": "number"}}],
                "responses": {"200": {"description": "job"},
                              "404": {"description": "not found"}}}},
            "/api/admin/profile": {"post": {
                "summary": "Capture a torch.profiler trace of the live "
                           "serving workload (admin; one at a time)",
                "requestBody": {"content": {"application/json": {"schema": {
                    "type": "object",
                    "properties": {"seconds": {"type": "number"},
                                   "trace_dir": {"type": "string"}}}}}},
                "responses": {"200": {"description": "trace_dir written"},
                              "403": {"description": "auth required"},
                              "409": {"description": "capture in progress"}}}},
            "/api/inference-jobs/{id}/complete/": {"post": {
                "summary": "External-worker completion callback (multipart "
                           "mask_image)",
                "responses": {"200": {"description": "job completed"},
                              "400": {"description": "already completed / "
                                                     "missing mask"}}}},
            "/api/metrics/": {"get": {
                "summary": "Platform counters",
                "responses": {"200": {"description": "counts"}}}},
            "/api/users/register/": {"post": {
                "summary": "Create account",
                "responses": {"201": {"description": "created"}}}},
            "/api/users/login/": {"post": {
                "summary": "Session login",
                "responses": {"200": {"description": "session cookie set"}}}},
            "/api/users/logout/": {"post": {
                "summary": "Destroy session",
                "responses": {"200": {"description": "logged out"}}}},
            "/api/users/current-user/": {"get": {
                "summary": "Authenticated user",
                "responses": {"200": {"description": "user"},
                              "403": {"description": "anonymous"}}}},
        },
        "components": {"schemas": {
            "InferenceJob": _JOB_SCHEMA,
            "VisionModel": _MODEL_SCHEMA,
            "PaginatedJobs": _paginated("#/components/schemas/InferenceJob"),
            "PaginatedModels": _paginated("#/components/schemas/VisionModel"),
        }},
    }


# ---------------------------------------------------------------- doc pages
# The reference serves swagger-ui and redoc UIs over the schema
# (reference backend/project/urls.py:30-32 via drf-spectacular). This
# deployment has no egress, so instead of CDN shells these pages embed a
# small self-contained renderer that fetches /api/schema/ and draws the
# endpoint/operation/response tables client-side.

_DOC_PAGE = """<!doctype html><html lang="en"><head>
<meta charset="utf-8"><title>{title}</title>
<style>
body{{font-family:{font};margin:0;color:#1a1a2e;background:#fafafa}}
header{{background:{accent};color:#fff;padding:16px 32px}}
header h1{{margin:0;font-size:20px}} main{{max-width:960px;margin:0 auto;padding:24px 32px}}
.op{{background:#fff;border:1px solid #e0e0e8;border-radius:6px;margin:12px 0;overflow:hidden}}
.op-head{{display:flex;gap:12px;align-items:center;padding:10px 14px;cursor:pointer}}
.method{{font-weight:700;font-size:12px;padding:3px 10px;border-radius:4px;color:#fff;min-width:44px;text-align:center}}
.get{{background:#2d7ff9}}.post{{background:#2fa36b}}.put{{background:#d88a1f}}.delete{{background:#d64545}}
.path{{font-family:ui-monospace,monospace;font-size:14px}}
.summary{{color:#666;font-size:13px;margin-left:auto}}
.op-body{{display:none;border-top:1px solid #eee;padding:12px 16px;font-size:13px}}
.op.open .op-body{{display:block}}
table{{border-collapse:collapse;width:100%;margin:6px 0}}
td,th{{border:1px solid #e4e4ec;padding:4px 10px;text-align:left;font-size:12px}}
pre{{background:#f4f4f8;padding:10px;border-radius:4px;overflow:auto;font-size:12px}}
h2{{font-size:15px;margin:24px 0 4px}}
</style></head><body>
<header><h1>{title}</h1></header><main id="root">Loading schema…</main>
<script>
fetch('/api/schema/').then(function(r){{return r.json()}}).then(function(s){{
  var root=document.getElementById('root');root.innerHTML='';
  var info=document.createElement('p');
  info.textContent=(s.info&&s.info.title||'')+' '+(s.info&&s.info.version||'');
  root.appendChild(info);
  Object.keys(s.paths).forEach(function(p){{
    Object.keys(s.paths[p]).forEach(function(m){{
      if(m==='parameters')return;
      var op=s.paths[p][m];
      var box=document.createElement('div');box.className='op';
      var head=document.createElement('div');head.className='op-head';
      var badge=document.createElement('span');
      badge.className='method '+m;badge.textContent=m.toUpperCase();
      var path=document.createElement('span');path.className='path';path.textContent=p;
      var sum=document.createElement('span');sum.className='summary';
      sum.textContent=op.summary||'';
      head.appendChild(badge);head.appendChild(path);head.appendChild(sum);
      var body=document.createElement('div');body.className='op-body';
      var rt=document.createElement('table');
      rt.innerHTML='<tr><th>status</th><th>description</th></tr>';
      Object.keys(op.responses||{{}}).forEach(function(code){{
        var tr=document.createElement('tr');
        var td1=document.createElement('td');td1.textContent=code;
        var td2=document.createElement('td');
        td2.textContent=op.responses[code].description||'';
        tr.appendChild(td1);tr.appendChild(td2);rt.appendChild(tr);
      }});
      body.appendChild(rt);
      head.onclick=function(){{box.classList.toggle('open')}};
      box.appendChild(head);box.appendChild(body);root.appendChild(box);
    }});
  }});
  var h2=document.createElement('h2');h2.textContent='Schemas';root.appendChild(h2);
  var pre=document.createElement('pre');
  pre.textContent=JSON.stringify(s.components&&s.components.schemas||{{}},null,2);
  root.appendChild(pre);
}}).catch(function(e){{
  document.getElementById('root').textContent='Failed to load /api/schema/: '+e;
}});
</script></body></html>"""


def swagger_ui_html() -> str:
    """Interactive endpoint explorer (role of swagger-ui at
    /api/schema/swagger-ui/, reference backend/project/urls.py:31)."""
    return _DOC_PAGE.format(title="visiontransformer_tpu_torch API — Swagger UI",
                            accent="#1b5e20", font="sans-serif")


def redoc_html() -> str:
    """Reference-style documentation page (role of redoc at
    /api/schema/redoc/, reference backend/project/urls.py:32)."""
    return _DOC_PAGE.format(title="visiontransformer_tpu_torch API — ReDoc",
                            accent="#1a237e", font="Georgia,serif")
