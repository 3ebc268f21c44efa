"""Stdlib HTTP front-end over the batching engine, counterpart of
``sls_tpu/serve/server.py``: the same endpoints, body forms, headers,
response keys and error codes.

Endpoints (all JSON responses):

- ``POST /score`` — one utterance.  Body either
  ``application/octet-stream``: raw little-endian int16 PCM (header
  ``X-Sample-Rate``, default 16000), or ``application/json``:
  ``{"wav": [floats], "sample_rate": 16000}``.
  Response ``{"score": P(bonafide), "latency_ms": ...}`` — the same
  score the offline score file would carry for this audio
  (reference contract: main.py:183-185).
- ``POST /score_batch`` — JSON ``{"wavs": [[...], ...], "sample_rate"}``;
  response ``{"scores": [...]}``.  Each utterance is submitted
  individually so the engine can interleave them with other traffic.
- ``POST /score_long`` — same body formats as /score for a clip of ANY
  length; scored with overlapping windows per the offline
  full-utterance contract (evaluation/overlap.extract_windows), window
  scores aggregated by header ``X-Aggregate`` (mean|min|max, default
  mean).  Response ``{"score", "n_windows", "aggregate", "latency_ms"}``.
- ``GET /healthz`` — liveness.
- ``GET /stats`` — engine counters + latency percentiles.

ThreadingHTTPServer gives one OS thread per in-flight request; each
parses its body (and resamples it on the host, ``data/audio.resample``)
and blocks on its Future, while the engine's one worker thread does
all the CUDA work in fixed-shape batches: concurrency on the socket side
never becomes shape churn, or a second stream, on the device side.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from sls_tpu_torch.serve.engine import BatchingEngine

_MAX_BODY = 64 * 1024 * 1024  # 64 MB: minutes of PCM, not a DoS vector
# pending connections the listening socket holds.  The stdlib's default
# of 5 (which the reference's server keeps) drops the SYNs of more
# concurrent clients, and each dropped client waits out TCP's 1 s and 3 s
# retransmission timers before its request reaches the engine.
LISTEN_BACKLOG = 1024


class _Server(ThreadingHTTPServer):
    request_queue_size = LISTEN_BACKLOG


def _parse_audio(handler: "_Handler") -> tuple:
    """(wav float32 [n], sample_rate) from the request body."""
    length = int(handler.headers.get("Content-Length", 0))
    if length <= 0:
        raise ValueError("empty request body")
    if length > _MAX_BODY:
        raise ValueError(f"body too large ({length} bytes)")
    body = handler.rfile.read(length)
    ctype = (handler.headers.get("Content-Type") or "").split(";")[0].strip()
    if ctype == "application/json":
        payload = json.loads(body)
        wav = np.asarray(payload["wav"], np.float32)
        sr = int(payload.get("sample_rate", 16000))
        return wav, sr
    # default: raw little-endian int16 PCM (the decoder's wire; data/flac.py)
    if length % 2:
        raise ValueError("odd byte count for int16 PCM")
    wav = np.frombuffer(body, "<i2").astype(np.float32) / 32768.0
    sr = int(handler.headers.get("X-Sample-Rate", 16000))
    return wav, sr


class _Handler(BaseHTTPRequestHandler):
    engine: BatchingEngine  # bound by make_server
    quiet: bool = True
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        if not self.quiet:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/stats":
            self._reply(200, self.engine.stats().to_dict())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        try:
            if self.path == "/score":
                wav, sr = _parse_audio(self)
                t0 = time.monotonic()
                score = self.engine.score(wav, sample_rate=sr)
                self._reply(200, {
                    "score": score,
                    "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
                })
            elif self.path == "/score_long":
                # long clip: overlap-window scoring, offline
                # full-utterance contract (engine.score_long)
                wav, sr = _parse_audio(self)
                agg = self.headers.get("X-Aggregate", "mean")
                if agg not in ("mean", "min", "max"):
                    raise ValueError(f"unknown aggregate {agg!r}")
                t0 = time.monotonic()
                score, n_win = self.engine.score_long(
                    wav, sample_rate=sr, aggregate=agg)
                self._reply(200, {
                    "score": score,
                    "n_windows": n_win,
                    "aggregate": agg,
                    "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
                })
            elif self.path == "/score_batch":
                length = int(self.headers.get("Content-Length", 0))
                if length > _MAX_BODY:
                    raise ValueError(f"body too large ({length} bytes)")
                payload = json.loads(self.rfile.read(length))
                sr = int(payload.get("sample_rate", 16000))
                futures = [
                    self.engine.submit(np.asarray(w, np.float32), sr)
                    for w in payload["wavs"]
                ]
                self._reply(200, {"scores": [f.result(60.0) for f in futures]})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:  # engine/model failure: visible, not a hang
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(
    engine: BatchingEngine,
    host: str = "127.0.0.1",
    port: int = 8321,
    quiet: bool = True,
) -> ThreadingHTTPServer:
    """Bind the HTTP server to a started engine (the caller owns both
    lifecycles; ``cli/serve.py`` wires them)."""
    handler = type("BoundHandler", (_Handler,), {
        "engine": engine, "quiet": quiet,
    })
    return _Server((host, port), handler)
