"""Client helper for the serving daemon's line-delimited JSON protocol
(the port's copy of ``repro.serve_daemon.client``).

    client = serve_client("/tmp/mage.sock")      # or "host:port"
    resp = client.submit(JobSpec(workload="merge", n=4096,
                                 memory_budget=64), execute=True)
    assert resp["cache"]["plan"] in ("hit", "miss")
    client.status(); client.close()

One client holds one connection and may pipeline many requests; it is
what ``python -m repro_torch submit`` uses.
"""

from __future__ import annotations

import dataclasses
import json
import socket


class ServeError(RuntimeError):
    """The daemon answered ``ok: false`` (``.response`` has the detail)."""

    def __init__(self, response: dict):
        super().__init__(response.get("error", "daemon request failed"))
        self.response = response
        self.rejected = bool(response.get("rejected"))


def _connect(address) -> socket.socket:
    if isinstance(address, tuple):
        return socket.create_connection(address)
    address = str(address)
    if ":" in address and "/" not in address:
        host, _, port = address.rpartition(":")
        return socket.create_connection((host, int(port)))
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(address)
    return s


class ServeClient:
    """One connection to a :class:`~.server.ServeDaemon`."""

    def __init__(self, address, timeout: float | None = None):
        self.address = address
        self._sock = _connect(address)
        if timeout is not None:
            self._sock.settimeout(timeout)
        self._rf = self._sock.makefile("r", encoding="utf-8")

    # -- plumbing ------------------------------------------------------------

    def request(self, req: dict) -> dict:
        """Send one request line, read one response line; raises
        :class:`ServeError` on ``ok: false`` responses."""
        self._sock.sendall((json.dumps(req) + "\n").encode())
        line = self._rf.readline()
        if not line:
            raise ConnectionError("daemon closed the connection")
        resp = json.loads(line)
        if not resp.get("ok", False):
            raise ServeError(resp)
        return resp

    def close(self) -> None:
        try:
            self._rf.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- operations ----------------------------------------------------------

    def ping(self) -> dict:
        return self.request({"op": "ping"})

    def status(self) -> dict:
        return self.request({"op": "status"})

    def shutdown(self) -> dict:
        return self.request({"op": "shutdown"})

    def submit(self, spec, execute: bool = False, check: bool = False,
               queue: bool = True, timeout: float | None = None,
               use_cache: bool = True,
               return_outputs: bool = False) -> dict:
        """Submit one job spec (a ``JobSpec`` or a plain spec dict)."""
        if dataclasses.is_dataclass(spec):
            spec = spec.to_dict()
        req = {"op": "submit", "spec": spec, "execute": execute,
               "check": check, "queue": queue, "use_cache": use_cache,
               "return_outputs": return_outputs}
        if timeout is not None:
            req["timeout"] = timeout
        return self.request(req)


def serve_client(address, timeout: float | None = None) -> ServeClient:
    """Connect to a serving daemon: a unix-socket path or ``host:port``."""
    return ServeClient(address, timeout=timeout)
