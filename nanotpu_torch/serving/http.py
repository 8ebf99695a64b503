"""A small threaded HTTP/1.1 server for the serving API.

The port's own copy of the behavior of nanotpu's hand-rolled handler
(``nanotpu/routes/server.py``'s ``_Handler`` and ``serve()``): keep-alive
connections, a ``Content-Length`` body, and ``api.dispatch(method, path,
body) -> (code, content_type, payload)``. A ``str``/``bytes`` payload is
written with ``Content-Length``; an iterator payload streams, with chunked
transfer encoding on HTTP/1.1 and a raw stream closed by the server on
HTTP/1.0.
"""

from __future__ import annotations

import json
import socketserver
import threading

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    411: "Length Required", 414: "URI Too Long",
    500: "Internal Server Error",
}


def _status_line(code: int) -> bytes:
    return f"HTTP/1.1 {code} {_REASONS.get(code, 'Status')}\r\n".encode()


def _error(message: str) -> str:
    return json.dumps({"error": message})


class _Handler(socketserver.StreamRequestHandler):
    api = None
    disable_nagle_algorithm = True
    #: idle keep-alive timeout between requests
    timeout = 60
    #: per-socket-operation deadline once a request has started
    IO_TIMEOUT = 10
    MAX_BODY = 32 * 1024 * 1024
    MAX_LINE = 8192
    MAX_HEADERS = 100

    def handle(self):
        try:
            self._serve_requests()
        except (ConnectionError, TimeoutError, OSError):
            return

    def _serve_requests(self):
        while True:
            line = self.rfile.readline(self.MAX_LINE)
            if not line or line in (b"\r\n", b"\n"):
                return
            if len(line) >= self.MAX_LINE and not line.endswith(b"\n"):
                self._write(414, "application/json",
                            _error("request line too long"), False)
                return
            self.connection.settimeout(self.IO_TIMEOUT)
            try:
                method, path, version = line.decode("latin-1").split()
            except ValueError:
                self._write(400, "application/json",
                            _error("malformed request line"), False)
                return
            length = 0
            keep_alive = version == "HTTP/1.1"
            chunked = False
            for _ in range(self.MAX_HEADERS + 1):
                h = self.rfile.readline(self.MAX_LINE)
                if h in (b"\r\n", b"\n", b""):
                    break
                if len(h) >= self.MAX_LINE and not h.endswith(b"\n"):
                    self._write(400, "application/json",
                                _error("header line too long"), False)
                    return
                k, _, v = h.partition(b":")
                k = k.strip().lower()
                if k == b"content-length":
                    try:
                        length = int(v.strip())
                    except ValueError:
                        length = -1
                elif k == b"connection":
                    keep_alive = v.strip().lower() != b"close"
                elif k == b"transfer-encoding":
                    chunked = v.strip().lower() != b"identity"
            else:
                self._write(400, "application/json",
                            _error("too many headers"), False)
                return
            if chunked:
                # a chunked request body is not parsed; dispatching an empty
                # body would desync the connection on the chunk bytes
                self._write(411, "application/json",
                            _error("chunked framing unsupported; send "
                                   "Content-Length"), False)
                return
            if length < 0 or length > self.MAX_BODY:
                self._write(400, "application/json",
                            _error("invalid Content-Length"), False)
                return
            body = self.rfile.read(length) if length else b""
            code, ctype, payload = self.api.dispatch(method, path, body)
            if isinstance(payload, (str, bytes)):
                self._write(code, ctype, payload, keep_alive)
            else:
                framed = version == "HTTP/1.1"
                self._write_chunked(code, ctype, payload,
                                    keep_alive and framed, framed)
                if not framed:
                    return
            if not keep_alive:
                return
            self.connection.settimeout(self.timeout)

    def _write(self, code: int, ctype: str, payload, keep_alive: bool):
        data = payload.encode() if isinstance(payload, str) else payload
        head = _status_line(code) + (
            f"Content-Type: {ctype}\r\nContent-Length: {len(data)}\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n"
        ).encode()
        self.wfile.write(head + data)
        self.wfile.flush()

    def _write_chunked(self, code: int, ctype: str, chunks, keep_alive: bool,
                       framed: bool):
        """Stream an iterator of str/bytes chunks, flushing each as it is
        produced (time to first token is the point)."""
        head = _status_line(code) + (
            f"Content-Type: {ctype}\r\n"
            + ("Transfer-Encoding: chunked\r\n" if framed else "")
            + f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n"
        ).encode()
        self.wfile.write(head)
        self.wfile.flush()
        try:
            for chunk in chunks:
                data = chunk.encode() if isinstance(chunk, str) else chunk
                if not data:
                    continue
                if framed:
                    data = f"{len(data):x}\r\n".encode() + data + b"\r\n"
                self.wfile.write(data)
                self.wfile.flush()
        finally:
            close = getattr(chunks, "close", None)
            if close is not None:
                close()  # release the generator's request resources
        if framed:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128


def serve(api, port: int, host: str = "0.0.0.0") -> socketserver.ThreadingTCPServer:
    """Start the server on a daemon thread and return its handle; call
    ``shutdown()`` and then ``server_close()`` on it to stop."""
    handler = type("BoundHandler", (_Handler,), {"api": api})
    server = _Server((host, port), handler)
    threading.Thread(
        target=server.serve_forever, daemon=True, name="http"
    ).start()
    return server
