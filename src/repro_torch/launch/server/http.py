"""Stdlib HTTP/SSE front-end over the serving pipeline (port of
``repro/launch/server/http.py``; the handler touches no tensor).

No new runtime dependencies: ``http.server.ThreadingHTTPServer`` gives
one handler thread per connection, and a streamed completion simply
writes server-sent events as its stream queue fills -- the pipeline's
decode/detokenize threads do the work, the handler thread only copies.

Endpoints::

    POST /v1/completions   {"prompt": [ints] | "text", "max_tokens": N,
                            "stream": true|false}
        stream=true  -> text/event-stream, one ``data: {json}`` line
                        per token batch, closed by ``data: [DONE]``
        stream=false -> one JSON body with the full completion
        429 (Backpressure) when the admission queue is full -- the
        rejected request consumed NOTHING engine-side (no generator
        draw, no slot), so accepted streams are unaffected.
    GET /healthz           liveness + queue/slot snapshot
    GET /metrics           strict-Prometheus text (counters, TTFT/ITL
                           quantiles, queue depths, pool utilization)
    GET /debug/trace       Chrome trace-event JSON snapshot of the
                           flight recorder (DESIGN.md §15) -- loads in
                           Perfetto / chrome://tracing.  ``?last_s=N``
                           restricts to the trailing N seconds.

String prompts are byte-tokenized (token id = byte value, mod the
vocab when it is smaller than 256) -- the same byte convention
serve.py prints completions with.
"""
from __future__ import annotations

import itertools
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from repro_torch.launch.batch_engine import Request
from repro_torch.launch.server.pipeline import Backpressure, ServingPipeline

__all__ = ["CompletionServer"]


def _shard_bytes(engine) -> dict:
    """Under a mesh, the cache's global bytes and, where it differs, one
    device's (``per_shard_bytes``, DESIGN.md §16); nothing without one.
    Shapes only: no device sync."""
    if getattr(engine, "mesh", None) is None:
        return {}
    states = engine.cache["attn"]
    total = sum(st.nbytes(persistent_only=False) for st in states)
    per = sum(st.nbytes(persistent_only=False, per_shard=True)
              for st in states)
    out = {"mesh_model_shards": engine.mesh.shape.get("model", 1),
           "cache_bytes": int(total)}
    if per != total:
        out["per_shard_bytes"] = int(per)
    return out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"  # connection-close delimits the SSE body
    server_version = "repro-serve/0.1"

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt, *args):  # noqa: N802 (stdlib name)
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _json(self, code: int, obj, headers=None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code: int, text: str, ctype: str) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -------------------------------------------------------------- routes
    def do_GET(self):  # noqa: N802
        pipe = self.server.pipeline
        parsed = urlparse(self.path)
        if parsed.path == "/healthz":
            self._json(200, {
                "ok": True,
                "slots_active": pipe.engine.n_active,
                "slots_capacity": pipe.engine.capacity,
                **pipe.queue_depths(),
                **_shard_bytes(pipe.engine),
            })
        elif parsed.path == "/metrics":
            self._text(200, pipe.metrics_text(), "text/plain; version=0.0.4")
        elif parsed.path == "/debug/trace":
            try:
                q = parse_qs(parsed.query)
                last_s = float(q["last_s"][0]) if "last_s" in q else None
            except (ValueError, TypeError):
                self._json(400, {"error": "last_s must be a number"})
                return
            self._json(200, pipe.trace.export(last_s=last_s))
        else:
            self._json(404, {"error": f"no route {parsed.path}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/v1/completions":
            self._json(404, {"error": f"no route {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt = self._tokenize(body.get("prompt"))
            max_tokens = int(body.get("max_tokens", 16))
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._json(400, {"error": f"bad request: {e}"})
            return
        rid = next(self.server.rids)
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_tokens)
        try:
            stream = self.server.pipeline.submit(req)
        except Backpressure as e:
            # Retry-After makes 429 actionable: the pipeline derives the
            # hold-off from its own queue depth at rejection time, so
            # well-behaved clients back off proportionally to the actual
            # backlog instead of hammering a full queue
            self._json(429, {"error": str(e), "retry": True,
                             "retry_after_s": e.retry_after},
                       headers={"Retry-After": str(e.retry_after)})
            return
        except ValueError as e:  # engine-side validation (s_max etc.)
            self._json(400, {"error": str(e)})
            return
        tr = self.server.pipeline.trace
        t0 = time.perf_counter()
        if body.get("stream"):
            self._stream_sse(rid, stream)
            tr.span_at("http.stream", t0, cat="http", rid=rid)
        else:
            toks, text, reason, timing = [], [], None, None
            while reason is None:
                ev = stream.get()
                toks.extend(ev.tokens)
                text.append(ev.text)
                reason = ev.finish_reason
                timing = ev.timing
            resp = {"rid": rid, "tokens": toks, "text": "".join(text),
                    "finish_reason": reason}
            if timing is not None:
                resp["timing"] = timing
            self._json(200, resp)
            tr.span_at("http.request", t0, cat="http", rid=rid)

    def _stream_sse(self, rid: int, stream) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        try:
            while True:
                ev = stream.get()
                # the detokenize stage pre-serialized the payload; the
                # handler thread only copies bytes
                self.wfile.write(f"data: {ev.sse}\n\n".encode())
                self.wfile.flush()
                if ev.finish_reason is not None:
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                    return
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-stream; the engine finishes the
            # request normally (slot reclaim on disconnect is future
            # work -- ROADMAP), the fan-out queue is dropped with the
            # handler
            return

    def _tokenize(self, prompt) -> np.ndarray:
        if isinstance(prompt, str):
            toks = np.frombuffer(prompt.encode(), np.uint8).astype(np.int32)
            vocab = self.server.vocab_size
            if vocab is not None and vocab < 256:
                toks = toks % vocab
        elif isinstance(prompt, (list, tuple)):
            toks = np.asarray(prompt, np.int32)
        else:
            raise ValueError("prompt must be a string or a token list")
        if toks.ndim != 1 or toks.size < 1:
            raise ValueError("prompt must be a non-empty 1-D token list")
        return toks


class CompletionServer:
    """The network shell: a ``ThreadingHTTPServer`` bound to one
    :class:`ServingPipeline`.  ``port=0`` binds an ephemeral port
    (tests); ``serve_forever`` blocks until ``shutdown`` (serve.py
    installs a SIGINT handler that drains the pipeline first)."""

    def __init__(self, pipeline: ServingPipeline, *,
                 host: str = "127.0.0.1", port: int = 8000,
                 vocab_size=None, verbose: bool = False):
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.pipeline = pipeline
        self.httpd.rids = itertools.count()
        self.httpd.vocab_size = vocab_size
        self.httpd.verbose = verbose
        self.host, self.port = self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def serve_forever(self) -> None:
        self.httpd.serve_forever(poll_interval=0.05)

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
