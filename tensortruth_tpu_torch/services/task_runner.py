"""Serial background task queue for index builds/downloads.

Behavioral mirror of reference services/task_runner.py:44-178: single-worker
executor (one background build at a time protects device memory), TaskInfo
progress/stage tracking, on_complete callbacks, task listing.
"""

from __future__ import annotations

import logging
import threading
import traceback
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Callable

logger = logging.getLogger(__name__)


def _now() -> str:
    return datetime.now(timezone.utc).isoformat()


@dataclass
class TaskInfo:
    id: str
    name: str
    status: str = "queued"  # queued | running | completed | failed
    stage: str = ""
    progress: int = 0
    total: int = 0
    error: str | None = None
    created_at: str = field(default_factory=_now)
    finished_at: str | None = None
    result: object = None

    def to_dict(self) -> dict:
        # ``result`` mirrors reference routes/tasks.py:24 (dict payloads
        # pass through; non-dict returns wrap as {"success": value}).
        result = self.result
        if result is not None and not isinstance(result, dict):
            result = {"success": result}
        return {
            "id": self.id,
            "name": self.name,
            "status": self.status,
            "stage": self.stage,
            "progress": self.progress,
            "total": self.total,
            "error": self.error,
            "created_at": self.created_at,
            "finished_at": self.finished_at,
            "result": result,
        }


class TaskRunner:
    def __init__(self):
        self._executor: ThreadPoolExecutor | None = None
        self._tasks: dict[str, TaskInfo] = {}
        self._lock = threading.Lock()

    def start(self) -> None:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="task-runner"
            )

    def stop(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    def submit(
        self,
        name: str,
        fn: Callable[..., object],
        on_complete: Callable[[TaskInfo], None] | None = None,
    ) -> TaskInfo:
        """fn receives a ``progress(stage, current, total)`` callable."""
        self.start()
        info = TaskInfo(id=uuid.uuid4().hex[:12], name=name)
        with self._lock:
            self._tasks[info.id] = info

        def progress(stage: str, current: int, total: int) -> None:
            info.stage, info.progress, info.total = stage, current, total

        def run():
            info.status = "running"
            try:
                info.result = fn(progress)
                info.status = "completed"
            except Exception as e:
                info.status = "failed"
                info.error = f"{e}\n{traceback.format_exc(limit=5)}"
                logger.error("task %s failed: %s", info.name, e)
            finally:
                info.finished_at = _now()
                if on_complete:
                    try:
                        on_complete(info)
                    except Exception:
                        logger.exception("on_complete for %s failed", info.name)

        assert self._executor is not None
        self._executor.submit(run)
        return info

    def get(self, task_id: str) -> TaskInfo | None:
        return self._tasks.get(task_id)

    def list(self) -> list[TaskInfo]:
        return sorted(self._tasks.values(), key=lambda t: t.created_at, reverse=True)
