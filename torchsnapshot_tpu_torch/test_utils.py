"""A single-host multi-process launcher for distributed tests, and
in-memory S3 and GCS stores for the cloud plugins.

Counterpart of ``run_with_subprocesses`` in ``torchsnapshot_tpu/test_utils.py``
(test_utils.py:234-300): ``world_size`` spawned worker processes meet on the
port's coordination store (``dist_store``, hosted by rank 0 on localhost),
each with this package's default process group initialized, and the
launcher returns ``{rank: result}``. With ``backend`` ("gloo" on the CPU)
the workers also join a ``torch.distributed`` world over TCP on localhost,
so that they can build ``DeviceMesh`` and ``DTensor`` state; the snapshot
path itself never calls a ``torch.distributed`` collective.

The store-host kill drills (test_utils.py:127-163 of the JAX package):
``expect_dead`` names ranks a test kills, ``store_replicas`` arms the
store's replication tier (ranks 1..N host standbys), and
``external_store`` runs the store leader in a dedicated process, in which
``store_host_plan`` arms a fault plan (``dist_store.serve_op@14=kill``
SIGKILLs it at the 14th client op it serves).
"""

from __future__ import annotations

import multiprocessing as mp
import queue as pyqueue
import socket
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

# Ports this process already handed out: a just-closed probe socket's port
# can be reassigned at once, so two allocations in a row could collide.
_handed_out_ports: "set[int]" = set()


def find_free_port() -> int:
    port = 0
    for _ in range(128):
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        finally:
            s.close()
        if port not in _handed_out_ports:
            _handed_out_ports.add(port)
            return port
    return port  # pragma: no cover - the kernel cycled through 128 ports


def _store_host_entry(
    store_addr: str, expected_replicas: int, fault_plan: str, lease_s: Optional[float]
) -> None:
    """A dedicated store-host process (no rank): hosts the leader at
    ``store_addr`` and serves until terminated, with ``fault_plan`` armed
    in this process."""
    from . import faultinject
    from .dist_store import TCPStore

    if fault_plan:
        faultinject.configure(fault_plan)
    host, _, port = store_addr.rpartition(":")
    # The leader's lease is the whole tier's (its sync frame carries it to
    # the standbys), so the launcher's knob must reach this process.
    server = TCPStore(
        host, int(port), is_server=True, expected_replicas=expected_replicas, lease_s=lease_s
    )
    try:
        while True:
            time.sleep(3600)
    finally:  # pragma: no cover - terminated by the launcher
        server.close()


def _worker_entry(
    fn: Callable,
    rank: int,
    world_size: int,
    store_addr: str,
    dist_addr: Optional[str],
    backend: Optional[str],
    result_queue,
    args: Tuple,
    store_cfg: Dict[str, Any],
    start,
    start_timeout: float,
) -> None:
    try:
        from .dist_store import create_store
        from .pg_wrapper import destroy_process_group, init_process_group

        store = create_store(
            rank=rank,
            addr=store_addr,
            replicas=store_cfg["replicas"],
            host_server=rank == 0 and not store_cfg["external"],
            lease_s=store_cfg["lease_s"],
        )
        init_process_group(store=store, rank=rank, world_size=world_size)
        if backend is not None:
            import torch.distributed as dist

            dist.init_process_group(
                backend, init_method=f"tcp://{dist_addr}", rank=rank, world_size=world_size
            )
        # Every rank starts ``fn`` once every rank is connected. The store
        # serves no op for this wait, so whatever the ranks' start skew,
        # every op after the connection probes comes from ``fn`` (the ops a
        # ``store_host_plan`` counts), and no rank finds the store gone
        # before it connected.
        start.wait(start_timeout)
        try:
            result = fn(rank, world_size, *args)
            destroy_process_group()  # this rank's exit is intentional, not a death
        finally:
            if backend is not None:
                import torch.distributed as dist

                if dist.is_initialized():
                    dist.destroy_process_group()
            # Exit barrier: the store server lives in rank 0's process, so
            # no rank may exit (taking it down) while peers still use it.
            try:
                if store.add("__exit__/count", 1) == world_size:
                    store.set("__exit__/done", b"1")
                store.get("__exit__/done", timeout=60.0)
            except Exception:  # noqa: BLE001 - a peer died; report what we have
                pass
        result_queue.put((rank, "ok", result))
    except BaseException:  # noqa: B036 - reported to the launcher
        result_queue.put((rank, "error", traceback.format_exc()))


def run_with_subprocesses(
    fn: Callable,
    world_size: int,
    *args: Any,
    timeout: float = 180.0,
    backend: Optional[str] = None,
    expect_dead: Tuple[int, ...] = (),
    store_replicas: int = 0,
    store_lease_s: Optional[float] = None,
    external_store: bool = False,
    store_host_plan: str = "",
) -> Dict[int, Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes that share a store rendezvous; return ``{rank: result}``.
    Raises on any rank's failure (with every failing rank's traceback) and
    on ``timeout`` seconds without every result. ``fn``, ``args`` and the
    results cross processes by pickle: ``fn`` must be importable.

    ``expect_dead``: ranks the test kills. They need not report; the
    launcher returns once every other rank has reported and they have
    exited. A report they made before dying is included, their error
    reports are dropped. ``store_replicas``, ``store_lease_s``,
    ``external_store`` and ``store_host_plan`` shape the store tier (see
    the module docstring); the external host is terminated at the end, and
    its death mid-run is never an error. Every rank calls ``fn`` once every
    rank has connected to the store (a barrier outside the store)."""
    ctx = mp.get_context("spawn")
    result_queue = ctx.Queue()
    store_addr = f"127.0.0.1:{find_free_port()}"
    dist_addr = f"127.0.0.1:{find_free_port()}" if backend is not None else None
    store_cfg = {"replicas": store_replicas, "lease_s": store_lease_s, "external": external_store}
    start = ctx.Barrier(world_size)
    store_host = None
    if external_store:
        store_host = ctx.Process(
            target=_store_host_entry,
            args=(store_addr, store_replicas, store_host_plan, store_lease_s),
            daemon=True,
        )
        store_host.start()
    procs = []
    for rank in range(world_size):
        p = ctx.Process(
            target=_worker_entry,
            args=(fn, rank, world_size, store_addr, dist_addr, backend, result_queue, args,
                  store_cfg, start, timeout),
            daemon=False,
        )
        p.start()
        procs.append(p)
    dead_set = set(expect_dead)
    survivors = set(range(world_size)) - dead_set
    results: Dict[int, Any] = {}
    errors = []

    def record(rank: int, status: str, payload: Any) -> None:
        if status == "ok":
            results[rank] = payload
        elif rank not in dead_set:
            errors.append((rank, payload))
            start.abort()  # ranks still waiting to start fail at once
        # else: a rank being killed may die messily; that is expected

    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world_size:
            reported = set(results) | {r for r, _ in errors}
            if dead_set and survivors <= reported and all(not procs[r].is_alive() for r in dead_set):
                # Every survivor reported and the doomed ranks are gone:
                # take what a doomed rank enqueued before dying, then stop.
                while True:
                    try:
                        item = result_queue.get_nowait()
                    except pyqueue.Empty:
                        break
                    record(*item)
                break
            try:
                record(*result_queue.get(timeout=1.0))
            except pyqueue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"multi-process run timed out after {timeout}s; results from ranks "
                        f"{sorted(results)} of {world_size}"
                    ) from None
                dead = [
                    r for r, p in enumerate(procs)
                    if r not in dead_set and not p.is_alive() and p.exitcode not in (0, None)
                ]
                if dead:
                    raise RuntimeError(f"worker rank(s) {dead} exited without a result")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        if store_host is not None:
            store_host.terminate()
            store_host.join(timeout=10)
    if errors:
        raise RuntimeError(
            "Worker failures:\n" + "\n".join(f"--- rank {r} ---\n{tb}" for r, tb in sorted(errors))
        )
    return results


# ------------------------------------------------ in-memory cloud stores
#
# The client calls the S3 and GCS plugins make, over dicts: the plugins'
# tests and chip_smoke.py drive them with no SDK and no network (neither
# boto3 nor google-cloud-storage is needed). Both fakes read each body
# before they fail, so a retry that did not rewind would store a short
# object.


class _FakeBody:
    def __init__(self, data: bytes) -> None:
        self._data = data

    def read(self) -> bytes:
        return self._data


class FakeS3Client:
    """``put_object``, ``get_object`` (with HTTP ``Range``),
    ``head_object``, ``delete_object`` and the four multipart calls; a part
    assembles on complete. ``fail_times`` transient failures come first;
    ``fail_part_numbers`` fail one upload of each of those parts."""

    def __init__(self, fail_times: int = 0, fail_part_numbers=()) -> None:
        self.store: Dict[Tuple[str, str], bytes] = {}
        self.uploads: Dict[str, Dict[int, bytes]] = {}
        self.aborted: list = []
        self.get_ranges: list = []
        self.put_attempts = 0
        self.part_attempts = 0
        self.parts_completed = 0
        self._fail_times = fail_times
        self._fail_part_numbers = set(fail_part_numbers)

    def _maybe_fail(self) -> None:
        if self._fail_times > 0:
            self._fail_times -= 1
            raise ConnectionError("fake transient")

    def put_object(self, Bucket, Key, Body):  # noqa: N803 - boto3's names
        self.put_attempts += 1
        data = Body.read()
        self._maybe_fail()
        self.store[(Bucket, Key)] = bytes(data)

    def get_object(self, Bucket, Key, Range=None):  # noqa: N803
        self._maybe_fail()
        data = self.store[(Bucket, Key)]
        if Range is not None:
            lo, _, hi = Range[len("bytes="):].partition("-")
            self.get_ranges.append((int(lo), int(hi)))
            data = data[int(lo):int(hi) + 1]  # HTTP ranges are inclusive
        return {"Body": _FakeBody(data)}

    def head_object(self, Bucket, Key):  # noqa: N803
        self._maybe_fail()
        return {"ContentLength": len(self.store[(Bucket, Key)])}

    def delete_object(self, Bucket, Key):  # noqa: N803
        self._maybe_fail()
        del self.store[(Bucket, Key)]

    def create_multipart_upload(self, Bucket, Key):  # noqa: N803
        self._maybe_fail()
        uid = f"upload-{len(self.uploads) + len(self.aborted) + self.parts_completed}"
        self.uploads[uid] = {}
        return {"UploadId": uid}

    def upload_part(self, Bucket, Key, UploadId, PartNumber, Body):  # noqa: N803
        self.part_attempts += 1
        data = Body.read()
        if PartNumber in self._fail_part_numbers:
            self._fail_part_numbers.discard(PartNumber)
            raise ConnectionError("fake transient part failure")
        self._maybe_fail()
        self.uploads[UploadId][PartNumber] = bytes(data)
        return {"ETag": f"etag-{PartNumber}"}

    def complete_multipart_upload(self, Bucket, Key, UploadId, MultipartUpload):  # noqa: N803
        self._maybe_fail()
        parts = [p["PartNumber"] for p in MultipartUpload["Parts"]]
        assert parts == sorted(parts)
        self.store[(Bucket, Key)] = b"".join(self.uploads[UploadId][n] for n in parts)
        self.parts_completed += len(parts)
        del self.uploads[UploadId]

    def abort_multipart_upload(self, Bucket, Key, UploadId):  # noqa: N803
        self.aborted.append(UploadId)
        self.uploads.pop(UploadId, None)


class FakeGCSBlob:
    """The blob calls of the GCS plugin: ``upload_from_file`` (resumable
    when ``chunk_size`` is set), ``download_as_bytes`` (end-inclusive
    ranges), ``reload``, ``size`` and ``delete``."""

    def __init__(self, store: dict, name: str, fail_times: int = 0) -> None:
        self.store = store
        self.name = name
        self.chunk_size = None
        self.upload_attempts = 0
        self.download_calls: list = []
        self._fail_times = fail_times

    def _maybe_fail(self) -> None:
        if self._fail_times > 0:
            self._fail_times -= 1
            raise ConnectionError("fake transient")

    def upload_from_file(self, stream, size):
        self.upload_attempts += 1
        data = stream.read(size)
        self._maybe_fail()
        assert len(data) == size, "stream not rewound before retry"
        self.store[self.name] = bytes(data)

    def download_as_bytes(self, start=0, end=None):
        self._maybe_fail()
        self.download_calls.append((start, end))
        data = self.store[self.name]
        return data[start:len(data) if end is None else end + 1]

    def reload(self) -> None:
        self._maybe_fail()

    @property
    def size(self) -> int:
        return len(self.store[self.name])

    def delete(self) -> None:
        self._maybe_fail()
        del self.store[self.name]


class FakeGCSBucket:
    """``blob(name)`` over one dict of objects; every new blob fails its
    first ``fail_times`` calls."""

    def __init__(self, fail_times: int = 0) -> None:
        self.store: Dict[str, bytes] = {}
        self.blobs: Dict[str, FakeGCSBlob] = {}
        self.fail_times = fail_times

    def blob(self, name: str) -> FakeGCSBlob:
        if name not in self.blobs:
            self.blobs[name] = FakeGCSBlob(self.store, name, self.fail_times)
        return self.blobs[name]
