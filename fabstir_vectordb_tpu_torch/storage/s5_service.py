"""Enhanced-S5 HTTP service (aiohttp): mock and real-portal modes.

A copy of the JAX package's ``storage/s5_service.py``.

Python equivalent of the reference's S5 services
(reference: bindings/node/services/s5-http-service.js — S5_MODE mock|real —
and test-s5-server/, the real-S5.js portal wrapper on :5522): a blob
service speaking the S5 path API the storage driver expects:

    PUT    /s5/fs/{path}      store blob (honors X-S5-Encryption header)
    GET    /s5/fs/{path}      fetch blob (404 when missing)
    DELETE /s5/fs/{path}      delete blob
    GET    /s5/fs/{prefix}/?list=1   list keys under prefix (JSON)
    GET    /health            service health + stats

Two modes (env ``S5_MODE``, default mock):
  - ``mock``: in-memory blobs; ``X-S5-Encryption`` is recorded, not applied.
  - ``real``: stateless proxy — every /s5/fs request is forwarded verbatim
    (method, body, encryption header) to the upstream portal at
    ``S5_PORTAL`` / ``S5_PORTAL_URL``, with per-request timeout
    ``S5_CONNECTION_TIMEOUT`` (seconds, default 30 — real S5 network ops
    take 5-10 s, reference README.md:250). This is the deployment shape of
    the reference's docker-compose.real-s5.yml: the engine talks to this
    service, this service talks to the S5 network.

Used by integration tests to exercise S5ObjectStore end-to-end (the
real-mode tier is gated behind ``STORAGE_MODE=real``, mirroring reference
tests/test_s5_real_integration.rs), and runnable standalone:
``python -m fabstir_vectordb_tpu_torch.storage.s5_service`` (env S5_PORT,
default 5522, matching the reference service's port).
"""
from __future__ import annotations

import os

import aiohttp
from aiohttp import web

#: request headers forwarded to the upstream portal in real mode
_FORWARD_HEADERS = ("X-S5-Encryption", "Content-Type", "Authorization",
                    "Range")


def create_s5_proxy_app(portal_url: str, timeout: float = 30.0) -> web.Application:
    """Real-portal proxy: forward /s5/fs/* to ``portal_url`` unchanged."""
    portal = portal_url.rstrip("/")
    client_timeout = aiohttp.ClientTimeout(total=timeout)

    async def _client(app: web.Application) -> None:
        app["client"] = aiohttp.ClientSession(timeout=client_timeout)
        yield
        await app["client"].close()

    async def proxy(request: web.Request):
        key = request.match_info["path"]
        url = f"{portal}/s5/fs/{key}"
        headers = {
            h: request.headers[h] for h in _FORWARD_HEADERS
            if h in request.headers
        }
        body = await request.read() if request.method == "PUT" else None
        try:
            async with request.app["client"].request(
                request.method, url, params=request.query,
                data=body, headers=headers,
            ) as resp:
                payload = await resp.read()
                return web.Response(
                    body=payload, status=resp.status,
                    content_type=resp.content_type,
                )
        except aiohttp.ClientError as e:
            return web.json_response(
                {"error": f"portal unreachable: {e}"}, status=502
            )

    async def health(request: web.Request):
        upstream = "unknown"
        try:
            async with request.app["client"].get(
                f"{portal}/health"
            ) as resp:
                upstream = "ok" if resp.status == 200 else f"http {resp.status}"
        except aiohttp.ClientError:
            upstream = "unreachable"
        return web.json_response(
            {"status": "ok", "mode": "real", "portal": portal,
             "upstream": upstream}
        )

    app = web.Application(client_max_size=256 * 1024 * 1024)
    app.cleanup_ctx.append(_client)
    app.router.add_route("PUT", "/s5/fs/{path:.*}", proxy)
    app.router.add_route("GET", "/s5/fs/{path:.*}", proxy)
    app.router.add_route("DELETE", "/s5/fs/{path:.*}", proxy)
    app.router.add_get("/health", health)
    return app


def create_s5_app() -> web.Application:
    blobs: dict[str, bytes] = {}
    encryption_seen: dict[str, str] = {}

    def _path_of(request: web.Request) -> str:
        return request.match_info["path"]

    async def put_blob(request: web.Request):
        key = _path_of(request)
        data = await request.read()
        blobs[key] = data
        algo = request.headers.get("X-S5-Encryption")
        if algo:
            encryption_seen[key] = algo
        return web.json_response({"path": key, "size": len(data)})

    async def get_blob(request: web.Request):
        key = _path_of(request)
        if request.query.get("list"):
            prefix = key.rstrip("/")
            keys = sorted(
                k for k in blobs if k.startswith(prefix + "/") or k == prefix
            )
            return web.json_response({"keys": keys})
        if key not in blobs:
            return web.json_response(
                {"error": f"not found: {key}"}, status=404
            )
        data = blobs[key]
        rng = request.headers.get("Range")
        if rng and rng.startswith("bytes="):
            # single-range partial GET (sub-chunk lazy cold serving reads
            # row spans this way); malformed ranges fall through to 200,
            # a fully-past-EOF range gets the spec's 416 (the client
            # truncates it to b'' per the ObjectStore contract)
            try:
                lo_s, hi_s = rng[len("bytes="):].split("-", 1)
                lo = int(lo_s)
                if lo >= len(data):
                    return web.Response(
                        status=416,
                        headers={"Content-Range": f"bytes */{len(data)}"},
                    )
                hi = min(int(hi_s), len(data) - 1) if hi_s else len(data) - 1
                if 0 <= lo <= hi:
                    return web.Response(
                        body=data[lo: hi + 1], status=206,
                        headers={"Content-Range":
                                 f"bytes {lo}-{hi}/{len(data)}"},
                    )
            except ValueError:
                pass
        return web.Response(body=data)

    async def delete_blob(request: web.Request):
        key = _path_of(request)
        blobs.pop(key, None)
        return web.json_response({"deleted": key})

    async def health(request: web.Request):
        return web.json_response(
            {"status": "ok", "mode": "mock", "blobs": len(blobs)}
        )

    app = web.Application(client_max_size=256 * 1024 * 1024)
    app["blobs"] = blobs
    app["encryption_seen"] = encryption_seen
    app.router.add_put("/s5/fs/{path:.*}", put_blob)
    app.router.add_get("/s5/fs/{path:.*}", get_blob)
    app.router.add_delete("/s5/fs/{path:.*}", delete_blob)
    app.router.add_get("/health", health)
    return app


def main() -> None:  # pragma: no cover
    port = int(os.environ.get("S5_PORT", "5522"))
    mode = os.environ.get("S5_MODE", "mock").lower()
    if mode == "real":
        portal = os.environ.get("S5_PORTAL") or os.environ.get("S5_PORTAL_URL")
        if not portal:
            raise SystemExit("S5_MODE=real requires S5_PORTAL (portal URL)")
        timeout = float(os.environ.get("S5_CONNECTION_TIMEOUT", "30"))
        web.run_app(create_s5_proxy_app(portal, timeout=timeout), port=port)
    else:
        web.run_app(create_s5_app(), port=port)


if __name__ == "__main__":  # pragma: no cover
    main()
