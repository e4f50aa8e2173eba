"""HTTP ObjectStore speaking the Enhanced S5.js service protocol.

A copy of the JAX package's ``storage/s5.py``.

Parity with the reference's production storage driver
(reference: src/storage/enhanced_s5_storage.rs):
  - paths ``{base}/s5/fs/{key}`` with PUT/GET/DELETE (:127-131);
  - 30s default timeout — load-bearing, real S5 ops take 5-10s
    (:55, README.md:129-130,250);
  - retry wrapper with linear backoff x3 (:104-125);
  - encryption-at-rest ON by default via ``X-S5-Encryption:
    xchacha20-poly1305`` header (:92-93,153-155);
  - Docker localhost -> host.docker.internal rewrite via /.dockerenv
    detection (:64-79);
  - optional in-memory write-through cache (:21,174-178) — bounded here
    rather than unbounded (deliberate fix).

Also includes ``S5Client`` lower-level helpers (upload/download by CID path,
list, metadata) mirroring src/storage/s5_client.rs:79-248.
"""
from __future__ import annotations

import os
import time
from urllib.parse import quote

from ..core.object_store import (
    NotFoundError,
    StorageError,
    _BaseStore,
)

try:
    import requests

    HAVE_REQUESTS = True
except Exception:  # pragma: no cover
    HAVE_REQUESTS = False

ENCRYPTION_HEADER = "X-S5-Encryption"
ENCRYPTION_ALGO = "xchacha20-poly1305"


def _rewrite_for_docker(url: str) -> str:
    if os.path.exists("/.dockerenv") and "localhost" in url:
        return url.replace("localhost", "host.docker.internal")
    return url


class _RangeUnsatisfiable(StorageError):
    """HTTP 416: the requested byte range starts past EOF (truncate to
    b'' per the ObjectStore contract; never retried)."""


class S5ObjectStore(_BaseStore):
    parallel_fetch = True  # HTTP gets release the GIL; fan-out pays off
    supports_range = True  # HTTP Range (client-side slice if 200 returned)

    def __init__(
        self,
        base_url: str,
        timeout: float = 30.0,
        retries: int = 3,
        encrypt_at_rest: bool = True,
        cache_bytes: int = 64 * 1024 * 1024,
        session=None,
    ):
        if not HAVE_REQUESTS:  # pragma: no cover
            raise StorageError("requests package unavailable")
        self.base_url = _rewrite_for_docker(base_url.rstrip("/"))
        self.timeout = timeout
        self.retries = retries
        self.encrypt_at_rest = encrypt_at_rest
        self._session = session or requests.Session()
        self._cache: dict[str, bytes] = {}
        self._cache_bytes = 0
        self._cache_cap = cache_bytes

    def _url(self, key: str) -> str:
        return f"{self.base_url}/s5/fs/{quote(key, safe='/')}"

    def _headers(self) -> dict:
        h = {}
        if self.encrypt_at_rest:
            h[ENCRYPTION_HEADER] = ENCRYPTION_ALGO
        return h

    def _request(self, method: str, key: str, data: bytes | None = None,
                 params: dict | None = None,
                 extra_headers: dict | None = None):
        last: Exception | None = None
        for attempt in range(self.retries):
            try:
                headers = self._headers()
                if extra_headers:
                    headers.update(extra_headers)
                resp = self._session.request(
                    method,
                    self._url(key),
                    data=data,
                    params=params,
                    headers=headers,
                    timeout=self.timeout,
                )
                if resp.status_code == 404:
                    raise NotFoundError(key)
                if resp.status_code == 416:
                    raise _RangeUnsatisfiable(key)  # definitive, no retry
                if resp.status_code >= 400:
                    raise StorageError(
                        f"S5 {method} {key} -> {resp.status_code}: {resp.text[:200]}"
                    )
                return resp
            except (NotFoundError, _RangeUnsatisfiable):
                raise
            except Exception as e:  # noqa: BLE001
                last = e
                if attempt < self.retries - 1:
                    time.sleep(0.5 * (attempt + 1))  # linear backoff
        raise StorageError(f"S5 {method} {key} failed after {self.retries} attempts") from last

    def get(self, key: str) -> bytes:
        if key in self._cache:
            return self._cache[key]
        data = self._request("GET", key).content
        self._cache_put(key, data)
        return data

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        """HTTP ``Range: bytes=`` partial GET. A service that ignores the
        header (200 + full body) still yields correct bytes via a client-
        side slice — the savings just don't materialize there. Partial
        responses are never inserted into the write-through cache."""
        if length <= 0:
            return b""
        if key in self._cache:
            return self._cache[key][offset: offset + length]
        try:
            resp = self._request(
                "GET", key,
                extra_headers={
                    "Range": f"bytes={offset}-{offset + length - 1}"},
            )
        except _RangeUnsatisfiable:
            # a spec-compliant server answers a fully-past-EOF range with
            # 416 Range Not Satisfiable; the _BaseStore contract truncates
            # instead of erroring (filesystem pread / memory slice parity)
            return b""
        data = resp.content
        if resp.status_code == 206:
            return data
        self._cache_put(key, data)  # full body: cache like a plain get
        return data[offset: offset + length]

    def put(self, key: str, data: bytes) -> None:
        self._request("PUT", key, data=bytes(data))
        self._cache_put(key, bytes(data))

    def delete(self, key: str) -> None:
        try:
            self._request("DELETE", key)
        except NotFoundError:
            pass
        self._cache.pop(key, None)

    def list_keys(self, prefix: str = "") -> list:
        # goes through the retry/encryption-header path like every other op
        try:
            resp = self._request("GET", prefix.rstrip("/"), params={"list": "1"})
        except NotFoundError:
            return []
        try:
            obj = resp.json()
        except Exception as e:
            raise StorageError("S5 list response not JSON") from e
        keys = obj.get("keys") or obj.get("files") or []
        return sorted(str(k) for k in keys)

    def health(self) -> bool:
        try:
            resp = self._session.get(f"{self.base_url}/health", timeout=self.timeout)
            return resp.status_code == 200
        except Exception:
            return False

    def _cache_put(self, key: str, data: bytes) -> None:
        old = self._cache.pop(key, None)
        if old is not None:
            self._cache_bytes -= len(old)
        if self._cache_bytes + len(data) > self._cache_cap:
            # drop oldest entries (insertion-ordered dict)
            for k in list(self._cache):
                dropped = self._cache.pop(k)
                self._cache_bytes -= len(dropped)
                if self._cache_bytes + len(data) <= self._cache_cap:
                    break
        self._cache[key] = data
        self._cache_bytes += len(data)


class S5Client:
    """Lower-level S5 REST helpers (CID upload/download, metadata)."""

    def __init__(self, base_url: str, timeout: float = 30.0, session=None):
        if not HAVE_REQUESTS:  # pragma: no cover
            raise StorageError("requests package unavailable")
        self.base_url = _rewrite_for_docker(base_url.rstrip("/"))
        self.timeout = timeout
        self._session = session or requests.Session()

    def upload(self, data: bytes) -> str:
        resp = self._session.post(
            f"{self.base_url}/s5/upload", data=data, timeout=self.timeout
        )
        if resp.status_code >= 400:
            raise StorageError(f"upload failed: {resp.status_code}")
        cid = resp.json().get("cid", "")
        return f"s5://{cid}" if cid and not cid.startswith("s5://") else cid

    def download(self, cid: str) -> bytes:
        cid = cid.removeprefix("s5://")
        resp = self._session.get(
            f"{self.base_url}/s5/blob/{quote(cid)}", timeout=self.timeout
        )
        if resp.status_code == 404:
            raise NotFoundError(cid)
        if resp.status_code >= 400:
            raise StorageError(f"download failed: {resp.status_code}")
        return resp.content

    def batch_upload(self, blobs: list) -> list:
        return [self.upload(b) for b in blobs]

    def health(self) -> bool:
        try:
            resp = self._session.get(f"{self.base_url}/health",
                                     timeout=self.timeout)
            return resp.status_code == 200
        except Exception:
            return False


class CidMapObjectStore(_BaseStore):
    """Content-addressed backend: a local key->CID map over an immutable
    CID blob store (reference: src/storage/s5_storage.rs — cid_map +
    metadata_map, zstd-compressed puts when enabled, "delete" only forgets
    the mapping because S5 content is immutable :211-221, list serves from
    the local map since S5 has no key listing).

    Beyond parity: the map can persist to a local file (``map_path``) so the
    key->CID index survives restarts — the reference loses it with the
    process.
    """

    parallel_fetch = True  # CID fetches ride HTTP; fan-out pays off

    def __init__(self, client: S5Client, enable_compression: bool = False,
                 map_path: str | None = None):
        self.client = client
        self.enable_compression = enable_compression
        self.map_path = map_path
        self.cid_map: dict[str, str] = {}
        self.metadata_map: dict[str, dict] = {}
        if map_path:
            self._load_map()

    # ------------------------------------------------------------ map file
    def _load_map(self) -> None:
        import json as _json

        try:
            with open(self.map_path, "r", encoding="utf-8") as f:
                obj = _json.load(f)
            self.cid_map = dict(obj.get("cid_map") or {})
            self.metadata_map = dict(obj.get("metadata_map") or {})
        except FileNotFoundError:
            pass

    def _save_map(self) -> None:
        if not self.map_path:
            return
        import json as _json

        with open(self.map_path, "w", encoding="utf-8") as f:
            _json.dump(
                {"cid_map": self.cid_map, "metadata_map": self.metadata_map}, f
            )

    # --------------------------------------------------------------- store
    def put(self, key: str, data: bytes) -> None:
        payload = bytes(data)
        compressed = False
        if self.enable_compression:
            from ..cbor import compress_zstd

            payload = compress_zstd(payload)
            compressed = True
        cid = self.client.upload(payload)
        self.cid_map[key] = cid
        self.metadata_map[key] = {
            "key": key,
            "cid": cid,
            "size": len(data),
            "created_at": int(time.time()),
            "compressed": compressed,
        }
        self._save_map()

    def get(self, key: str) -> bytes:
        cid = self.cid_map.get(key)
        if cid is None:
            raise NotFoundError(key)
        data = self.client.download(cid)
        meta = self.metadata_map.get(key) or {}
        if meta.get("compressed"):
            from ..cbor import decompress_zstd

            data = decompress_zstd(data)
        return data

    def delete(self, key: str) -> None:
        # S5 content is immutable: deleting only forgets the mapping
        self.cid_map.pop(key, None)
        self.metadata_map.pop(key, None)
        self._save_map()

    def list_keys(self, prefix: str = "") -> list:
        return sorted(k for k in self.cid_map if k.startswith(prefix))

    def exists(self, key: str) -> bool:
        return key in self.cid_map

    def get_cid(self, key: str) -> str:
        cid = self.cid_map.get(key)
        if cid is None:
            raise NotFoundError(f"CID not found for key: {key}")
        return cid

    def get_by_cid(self, cid: str) -> bytes:
        if not cid.startswith("s5://"):
            raise StorageError(f"Invalid CID format: {cid}")
        return self.client.download(cid)

    def is_connected(self) -> bool:
        return self.client.health()
