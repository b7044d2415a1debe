"""OpenAI-compatible HTTP frontend on the standard library.

Counterpart of dynamo_tpu/frontend/http.py, trimmed to the serving path:
  POST /v1/chat/completions   (SSE stream ending in [DONE], or unary)
  POST /v1/completions        (the same, as text_completion objects)
  GET  /v1/models
  GET  /health
`http.server.ThreadingHTTPServer` gives each connection its own thread;
the engine runs on its own thread behind per-request queues, so a handler
thread only blocks on its own request's stream. A client that goes away
mid-stream closes the stream, which aborts the request in the engine.
Errors before the first chunk become HTTP statuses: 400 for a bad
request, 404 for an unknown model, 501 for a case this package refuses
(a feature not ported yet), 500 otherwise.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from dynamo_tpu_torch.frontend.service import ModelManager
from dynamo_tpu_torch.protocols.openai import (
    SSE_DONE,
    ChatCompletionRequest,
    CompletionChoice,
    CompletionLogprobs,
    CompletionRequest,
    CompletionResponse,
    ModelInfo,
    ModelList,
    aggregate_chat_stream,
    dump,
    now,
    sse_event,
)

logger = logging.getLogger(__name__)


def _legacy_completion_chunk(chunk, text_offsets: dict[int, int]) -> dict:
    """/v1/completions streams text_completion objects, not chat chunks:
    choices carry `text` and the legacy parallel-array logprobs, whose
    offsets count from the start of the choice's text (text_offsets keeps
    each choice's emitted length across the stream)."""
    out = {
        "id": chunk.id,
        "object": "text_completion",
        "created": chunk.created,
        "model": chunk.model,
        "choices": [],
    }
    for c in chunk.choices:
        text = c.delta.content or ""
        choice = {"index": c.index, "text": text, "finish_reason": c.finish_reason}
        if c.logprobs is not None:
            choice["logprobs"] = dump(CompletionLogprobs.from_entries(
                c.logprobs.content, text_offsets.get(c.index, 0)))
        text_offsets[c.index] = text_offsets.get(c.index, 0) + len(text)
        if c.token_ids is not None:
            choice["token_ids"] = c.token_ids
        out["choices"].append(choice)
    if chunk.usage is not None:
        out["usage"] = dump(chunk.usage)
    return out


def _status_for(err: Exception) -> int:
    if isinstance(err, ValueError):
        return 400
    if isinstance(err, NotImplementedError):
        return 501
    return 500


class HttpService:
    def __init__(self, manager: ModelManager, host: str = "127.0.0.1", port: int = 8080):
        self.manager = manager
        self.host = host
        self.port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Bind (port 0 picks a free one, read back into .port) and serve
        on a background thread."""
        self._server = ThreadingHTTPServer((self.host, self.port), _handler_for(self))
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="http"
        )
        self._thread.start()
        logger.info("http frontend on %s:%d", self.host, self.port)

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


def _handler_for(service: HttpService):
    manager = service.manager

    class Handler(BaseHTTPRequestHandler):
        server_version = "dynamo-tpu-torch"

        def log_message(self, fmt, *args):  # route access logs to logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _json(self, status: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok", "models": manager.list_models()})
            elif self.path == "/v1/models":
                listing = ModelList(
                    data=[ModelInfo(id=m, created=now()) for m in manager.list_models()]
                )
                self._json(200, dump(listing))
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/v1/chat/completions":
                self._serve("chat")
            elif self.path == "/v1/completions":
                self._serve("completion")
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def _serve(self, kind: str) -> None:
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"null")
            except (ValueError, UnicodeDecodeError):
                self._json(400, {"error": "invalid JSON body"})
                return
            try:
                req = (ChatCompletionRequest if kind == "chat" else CompletionRequest).from_json(body)
            except ValueError as e:
                self._json(400, {"error": f"invalid request: {e}"})
                return
            pipeline = manager.get(req.model)
            if pipeline is None:
                self._json(404, {"error": f"model {req.model!r} not found"})
                return
            chunks = None
            try:
                stream_fn = pipeline.chat_stream if kind == "chat" else pipeline.completion_stream
                chunks = stream_fn(req)
                if req.stream:
                    # the first chunk comes before the headers, so a refusal
                    # is a real HTTP status and not an error event
                    first = next(chunks, None)
                    self._stream(kind, first, chunks)
                else:
                    self._unary(kind, req, list(chunks))
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away; closing the stream aborts it
            except Exception as e:
                if _status_for(e) == 500:
                    logger.exception("request failed")
                self._json(_status_for(e), {"error": str(e)})
            finally:
                if chunks is not None:
                    chunks.close()

        def _unary(self, kind: str, req, chunks) -> None:
            rid = chunks[0].id if chunks else "unknown"
            resp = aggregate_chat_stream(chunks, req.model, rid)
            if kind == "completion":
                resp = CompletionResponse(
                    id=resp.id, created=resp.created, model=req.model,
                    choices=[
                        CompletionChoice(
                            index=c.index, text=c.message.content or "",
                            logprobs=None if c.logprobs is None
                            else CompletionLogprobs.from_entries(c.logprobs.content),
                            finish_reason=c.finish_reason, token_ids=c.token_ids,
                        )
                        for c in resp.choices
                    ],
                    usage=resp.usage,
                )
            self._json(200, dump(resp))

        def _stream(self, kind: str, first, chunks) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            text_offsets: dict[int, int] = {}  # per choice, for legacy logprobs
            try:
                for chunk in ([first] if first is not None else []):
                    self._event(kind, chunk, text_offsets)
                for chunk in chunks:
                    self._event(kind, chunk, text_offsets)
            except (BrokenPipeError, ConnectionResetError):
                raise
            except Exception as e:  # headers are out: the error rides the SSE
                logger.exception("stream failed")
                self.wfile.write(sse_event({"error": {"message": str(e)}}))
            self.wfile.write(SSE_DONE)
            self.wfile.flush()

        def _event(self, kind: str, chunk, text_offsets: dict[int, int]) -> None:
            payload = chunk if kind == "chat" else _legacy_completion_chunk(chunk, text_offsets)
            self.wfile.write(sse_event(payload))
            self.wfile.flush()

    return Handler
