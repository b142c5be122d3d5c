"""An in-process fake Hydrus Client API server: the benchmark's own copy of
the repository's test server (``tests/fake_hydrus.FakeHydrus``), cut to
the endpoints a search run calls: the API version and key checks, the
services, the file search, the potential-duplicate count and the
relationship POSTs, which it keeps for the check.

It binds 127.0.0.1 on a free port and serves from one thread.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

ACCESS_KEY = "f" * 64
FILE_SERVICE_KEY = "0123456789abcdef" * 4
ALL_PERMISSIONS = list(range(13))


class FakeHydrus:
    """``files``: {file hash: bytes}. ``start()``, point the client at
    ``url``, read ``relationships`` (unordered hash pairs) and
    ``relationship_posts`` (every POSTed relationship, in order)."""

    def __init__(self, files: dict[str, bytes] | None = None, access_key: str = ACCESS_KEY):
        self.files = dict(files or {})
        self.access_key = access_key
        self.relationships: set[tuple[str, str]] = set()
        self.relationship_posts: list[dict] = []
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def clear_relationships(self) -> None:
        self.relationships = set()
        self.relationship_posts = []

    def start(self) -> str:
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _key_ok(self) -> bool:
                if self.headers.get("Hydrus-Client-API-Access-Key") != fake.access_key:
                    self._send(401, {"error": "bad access key"})
                    return False
                return True

            def do_GET(self):
                parsed = urlparse(self.path)
                path = parsed.path
                params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                if path == "/api_version":
                    return self._send(200, {"version": 70, "hydrus_version": 600})
                if not self._key_ok():
                    return
                if path == "/verify_access_key":
                    return self._send(200, {
                        "name": "fake", "permits_everything": True,
                        "basic_permissions": ALL_PERMISSIONS, "human_description": "fake key",
                    })
                if path == "/get_services":
                    service = {
                        "name": "all local files", "service_key": FILE_SERVICE_KEY, "type": 15,
                        "type_pretty": "virtual combined local file service",
                    }
                    return self._send(200, {
                        "all_local_files": [service], "services": {FILE_SERVICE_KEY: service},
                    })
                if path == "/get_files/search_files":
                    json.loads(params["tags"])
                    return self._send(200, {"hashes": sorted(fake.files)})
                if path == "/manage_file_relationships/get_potentials_count":
                    return self._send(200, {"potential_duplicates_count": len(fake.relationships)})
                return self._send(404, {"error": f"unhandled GET {path}"})

            def do_POST(self):
                path = urlparse(self.path).path
                if not self._key_ok():
                    return
                payload = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))) or b"{}")
                if path == "/manage_file_relationships/set_file_relationships":
                    for rel in payload["relationships"]:
                        fake.relationship_posts.append(rel)
                        if rel.get("relationship") == 0:
                            a, b = rel["hash_a"], rel["hash_b"]
                            fake.relationships.add((min(a, b), max(a, b)))
                    return self._send(200, {})
                return self._send(404, {"error": f"unhandled POST {path}"})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.url

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address
        return f"http://{host}:{port}"

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = None
