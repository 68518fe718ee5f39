"""Memory-budgeted asyncio pipelines for write and read requests.

Counterpart of the buffered pipelines of ``torchsnapshot_tpu/scheduler.py``
(``execute_write_reqs``, ``sync_execute_write_reqs``,
``sync_execute_read_reqs``, ``PendingIOWork``,
``get_process_memory_budget_bytes``), with the JAX package's heuristic
defaults and none of its autotuning, streaming, fan-out, forensics or
telemetry.

Write pipeline::

    ready_for_staging -> staging -> ready_for_io -> io -> done

Staging (the DtoH copy into pinned memory, serialization, checksum) is
admitted under the per-process host-memory budget, largest entries first,
with a starvation escape that admits one over-budget entry when nothing
else is in flight. ``execute_write_reqs`` returns a :class:`PendingIOWork`
as soon as every entry is staged: that is the consistency point
``async_take`` returns at, while storage writes go on in the background.

Read pipeline: read -> consume, under the same budget.

The budget is ``min(0.6 * available memory, 32 GiB)``, or
``TORCHSNAPSHOT_GPU_PER_RANK_MEMORY_BUDGET_BYTES`` when set.
"""

from __future__ import annotations

import asyncio
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Set

from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO, WriteReq

logger = logging.getLogger(__name__)

try:
    _CPU_COUNT = len(os.sched_getaffinity(0)) or 1
except (AttributeError, OSError):  # pragma: no cover - non-Linux
    _CPU_COUNT = os.cpu_count() or 1
_CPU_CONCURRENCY = min(4, max(2, _CPU_COUNT // 2))
_IO_CONCURRENCY = min(16, max(8, 2 * _CPU_COUNT))
_AVAILABLE_MEMORY_MULTIPLIER = 0.6
_MAX_PER_RANK_MEMORY_BUDGET_BYTES = 32 * 1024**3
MEMORY_BUDGET_ENV_VAR = "TORCHSNAPSHOT_GPU_PER_RANK_MEMORY_BUDGET_BYTES"


def _available_memory_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def get_process_memory_budget_bytes() -> int:
    env = os.environ.get(MEMORY_BUDGET_ENV_VAR)
    if env is not None:
        return int(env)
    return min(
        int(_available_memory_bytes() * _AVAILABLE_MEMORY_MULTIPLIER),
        _MAX_PER_RANK_MEMORY_BUDGET_BYTES,
    )


class _MemoryBudget:
    def __init__(self, budget_bytes: int) -> None:
        self.available = budget_bytes

    def acquire(self, nbytes: int) -> None:
        self.available -= nbytes

    def release(self, nbytes: int) -> None:
        self.available += nbytes


class _WritePipeline:
    def __init__(self, write_req: WriteReq) -> None:
        self.write_req = write_req
        self.staging_cost_bytes = write_req.buffer_stager.get_staging_cost_bytes()
        self.buf = None
        self.buf_size_bytes = 0

    async def stage_buffer(self, executor) -> "_WritePipeline":
        self.buf = await self.write_req.buffer_stager.stage_buffer(executor)
        self.buf_size_bytes = memoryview(self.buf).nbytes
        return self

    async def write_buffer(self, storage: StoragePlugin) -> "_WritePipeline":
        # A payload an incremental base already holds is not written.
        if not self.write_req.buffer_stager.io_skipped:
            await storage.write(WriteIO(path=self.write_req.path, buf=self.buf))
        self.buf = None  # release the staged buffer eagerly
        return self


async def _cancel_all(tasks: Set[asyncio.Task]) -> None:
    for task in tasks:
        task.cancel()
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)


class PendingIOWork:
    """Storage writes still in flight after staging completed."""

    def __init__(
        self,
        ready_for_io: List[_WritePipeline],
        io_tasks: Set[asyncio.Task],
        storage: StoragePlugin,
        budget: _MemoryBudget,
        executor: ThreadPoolExecutor,
    ) -> None:
        self._ready_for_io = ready_for_io
        self._io_tasks = io_tasks
        self._storage = storage
        self._budget = budget
        self._executor = executor

    def _dispatch_io(self) -> None:
        loop = asyncio.get_running_loop()
        while self._ready_for_io and len(self._io_tasks) < _IO_CONCURRENCY:
            pipeline = self._ready_for_io.pop(0)
            self._io_tasks.add(loop.create_task(pipeline.write_buffer(self._storage)))

    async def complete(self) -> None:
        try:
            while self._io_tasks or self._ready_for_io:
                self._dispatch_io()
                done, self._io_tasks = await asyncio.wait(
                    self._io_tasks, return_when=asyncio.FIRST_COMPLETED
                )
                for task in done:
                    self._budget.release(task.result().buf_size_bytes)
        except BaseException:
            await _cancel_all(self._io_tasks)
            self._io_tasks = set()
            self._ready_for_io.clear()
            raise
        finally:
            self._executor.shutdown(wait=True)

    def sync_complete(self, event_loop: asyncio.AbstractEventLoop) -> None:
        event_loop.run_until_complete(self.complete())


async def execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
) -> PendingIOWork:
    loop = asyncio.get_running_loop()
    executor = ThreadPoolExecutor(max_workers=_CPU_CONCURRENCY)
    budget = _MemoryBudget(memory_budget_bytes)
    # Largest first: better budget packing, and the slowest copies
    # overlap with the I/O of everything else.
    ready_for_staging = sorted(
        (_WritePipeline(req) for req in write_reqs),
        key=lambda p: p.staging_cost_bytes,
        reverse=True,
    )
    staging_tasks: Set[asyncio.Task] = set()
    io_tasks: Set[asyncio.Task] = set()
    ready_for_io: List[_WritePipeline] = []

    def dispatch_staging() -> None:
        while ready_for_staging:
            cost = ready_for_staging[0].staging_cost_bytes
            if cost > budget.available and (staging_tasks or io_tasks or ready_for_io):
                break  # over budget; the starvation escape admits it when idle
            pipeline = ready_for_staging.pop(0)
            budget.acquire(cost)
            staging_tasks.add(loop.create_task(pipeline.stage_buffer(executor)))

    def dispatch_io() -> None:
        while ready_for_io and len(io_tasks) < _IO_CONCURRENCY:
            pipeline = ready_for_io.pop(0)
            io_tasks.add(loop.create_task(pipeline.write_buffer(storage)))

    dispatch_staging()
    try:
        while staging_tasks or ready_for_staging:
            done, _ = await asyncio.wait(
                staging_tasks | io_tasks, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                pipeline = task.result()
                if task in staging_tasks:
                    staging_tasks.discard(task)
                    budget.release(pipeline.staging_cost_bytes - pipeline.buf_size_bytes)
                    ready_for_io.append(pipeline)
                else:
                    io_tasks.discard(task)
                    budget.release(pipeline.buf_size_bytes)
            dispatch_io()
            dispatch_staging()
    except BaseException:
        await _cancel_all(staging_tasks | io_tasks)
        executor.shutdown(wait=True)
        raise
    logger.debug("[rank %d] staged %d write(s)", rank, len(write_reqs))
    return PendingIOWork(ready_for_io, io_tasks, storage, budget, executor)


def sync_execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    pending = event_loop.run_until_complete(
        execute_write_reqs(write_reqs, storage, memory_budget_bytes, rank)
    )
    pending.sync_complete(event_loop)


class _ReadPipeline:
    def __init__(self, read_req: ReadReq) -> None:
        self.read_req = read_req
        self.cost_bytes = read_req.buffer_consumer.get_consuming_cost_bytes()

    async def read_and_consume(self, storage: StoragePlugin, executor) -> "_ReadPipeline":
        read_io = ReadIO(path=self.read_req.path, byte_range=self.read_req.byte_range)
        await storage.read(read_io)
        await self.read_req.buffer_consumer.consume_buffer(read_io.buf, executor)
        return self


async def execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
) -> None:
    loop = asyncio.get_running_loop()
    budget = _MemoryBudget(memory_budget_bytes)
    pending = sorted(
        (_ReadPipeline(req) for req in read_reqs),
        key=lambda p: p.cost_bytes,
        reverse=True,
    )
    tasks: Set[asyncio.Task] = set()
    with ThreadPoolExecutor(max_workers=_CPU_CONCURRENCY) as executor:
        try:
            while pending or tasks:
                while pending and len(tasks) < _IO_CONCURRENCY:
                    cost = pending[0].cost_bytes
                    if cost > budget.available and tasks:
                        break
                    pipeline = pending.pop(0)
                    budget.acquire(cost)
                    tasks.add(loop.create_task(pipeline.read_and_consume(storage, executor)))
                done, tasks = await asyncio.wait(tasks, return_when=asyncio.FIRST_COMPLETED)
                for task in done:
                    budget.release(task.result().cost_bytes)
        except BaseException:
            await _cancel_all(tasks)
            raise
    logger.debug("[rank %d] read %d request(s)", rank, len(read_reqs))


def sync_execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    event_loop.run_until_complete(
        execute_read_reqs(read_reqs, storage, memory_budget_bytes, rank)
    )
