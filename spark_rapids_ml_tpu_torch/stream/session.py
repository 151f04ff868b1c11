#
# StreamingSession: train-while-serve orchestration (srml-stream).
#
# Counterpart of spark_rapids_ml_tpu/stream/session.py.  A session consumes
# chunks through a streaming engine, tracks rows ingested and staleness
# (rows / chunks / seconds since the serving plane last saw a snapshot), and
# on refresh() materializes a model snapshot and hands it to the serving
# planes: the first snapshot is registered (registry.register /
# router.serve), every later one swapped in (registry.swap / router.swap).
# The planes are duck-typed, as in the JAX package: the port's
# serving.ModelRegistry and serving.Router are two.  One threading.Lock serializes snapshot,
# swap and bookkeeping, so a staleness watcher calling refresh() beside the
# ingest loop's refresh_every_rows trigger cannot interleave two swaps.
#

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, Optional

from torch.profiler import record_function

from .. import profiling
from .engines import StreamingEngine


class StreamingSession:
    """One continuously learning model: an engine and its serving refresh.

    `registry` / `router` are optional serving planes; refresh() registers
    the first snapshot under `name` and swaps every later one.  With
    neither, refresh() still snapshots and resets the staleness clock, and
    the caller serves the returned model where it likes."""

    def __init__(
        self,
        engine: StreamingEngine,
        name: Optional[str] = None,
        registry: Any = None,
        router: Any = None,
        **serve_kwargs: Any,
    ):
        if (registry is not None or router is not None) and not name:
            raise ValueError("a serving plane needs a model name; pass name=")
        self._engine = engine
        self._name = name
        self._registry = registry
        self._router = router
        self._serve_kwargs = dict(serve_kwargs)
        self._refreshes = 0
        self._rows_at_refresh = 0
        self._chunks_at_refresh = 0
        self._last_refresh_t: Optional[float] = None
        self._model: Any = None
        self._refresh_lock = threading.Lock()

    # -- ingest ------------------------------------------------------------
    @property
    def engine(self) -> StreamingEngine:
        return self._engine

    def partial_fit(self, chunk: Any, y: Any = None, weight: Any = None) -> "StreamingSession":
        """Ingest one chunk (a stream.ingest range around the engine's
        stream.update)."""
        with record_function("stream.ingest"):
            self._engine.partial_fit(chunk, y=y, weight=weight)
        return self

    def ingest(self, chunks: Iterable[Any], refresh_every_rows: int = 0) -> "StreamingSession":
        """Drain a chunk iterator; with refresh_every_rows > 0, refresh()
        whenever that many rows have come in since the last snapshot."""
        for chunk in chunks:
            self.partial_fit(chunk)
            if refresh_every_rows > 0 and self.staleness_rows >= refresh_every_rows:
                self.refresh()
        return self

    # -- staleness ---------------------------------------------------------
    @property
    def rows_ingested(self) -> int:
        return self._engine.rows_ingested

    @property
    def staleness_rows(self) -> int:
        """Rows ingested since the serving plane last saw a snapshot."""
        return self._engine.rows_ingested - self._rows_at_refresh

    @property
    def staleness_chunks(self) -> int:
        return self._engine.chunks_ingested - self._chunks_at_refresh

    @property
    def staleness_seconds(self) -> Optional[float]:
        if self._last_refresh_t is None:
            return None
        return time.monotonic() - self._last_refresh_t

    def stats(self) -> Dict[str, Any]:
        return {
            "name": self._name,
            "engine": self._engine.kind,
            "rows_ingested": self._engine.rows_ingested,
            "chunks_ingested": self._engine.chunks_ingested,
            "refreshes": self._refreshes,
            "staleness_rows": self.staleness_rows,
            "staleness_chunks": self.staleness_chunks,
            "staleness_seconds": self.staleness_seconds,
        }

    # -- refresh -----------------------------------------------------------
    def snapshot(self) -> Any:
        """A fitted model of the current state, without touching the
        serving planes or the staleness clock."""
        return self._engine.finalize()

    def refresh(self) -> Any:
        """Snapshot the current state and push it to the serving plane(s):
        the first refresh registers, every later one swaps.  Returns the
        snapshot."""
        with self._refresh_lock:
            with record_function("stream.refresh"):
                model = self.snapshot()
                if self._registry is not None:
                    if self._name in self._registry:
                        self._registry.swap(self._name, model)
                    else:
                        self._registry.register(self._name, model, **self._serve_kwargs)
                if self._router is not None:
                    if self._name in self._router:
                        self._router.swap(self._name, model)
                    else:
                        self._router.serve(self._name, model, **self._serve_kwargs)
            self._model = model
            self._refreshes += 1
            self._rows_at_refresh = self._engine.rows_ingested
            self._chunks_at_refresh = self._engine.chunks_ingested
            self._last_refresh_t = time.monotonic()
        profiling.incr_counter("stream.refreshes")
        return model
