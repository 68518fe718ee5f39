"""An in-memory object store behind the port's S3 plugin.

The client calls ``storage_plugins/s3.py`` makes (``put_object``,
``get_object`` with an HTTP ``Range``, ``head_object``,
``delete_object`` and the four multipart calls) over one dict, as the
port's test double does, with no fault injection and nothing recorded per
call. The benchmark drops whole snapshots by prefix once a newer one has
committed, so a run holds at most two.

The store behaves like a service whose memory is already there: an object
is copied into a buffer drawn from a pool of buffers of its size, which
deleted objects return to, and a read returns a view of the stored bytes.
:meth:`MemoryS3Client.reserve` faults the pool's pages in during set-up,
so that no take in the window pays the host's first touch of fresh pages.
"""

from __future__ import annotations

import io
import threading
from typing import Dict, Iterable, List, Tuple

import numpy as np

_PAGE = 4096


class _Body:
    def __init__(self, data: memoryview) -> None:
        self._data = data

    def read(self) -> memoryview:
        return self._data


class MemoryS3Client:
    def __init__(self) -> None:
        self.store: Dict[Tuple[str, str], bytearray] = {}
        self._free: Dict[int, List[bytearray]] = {}
        self._uploads: Dict[str, Dict[int, bytes]] = {}
        self._next_upload = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------ buffers
    def _buffer(self, n: int) -> bytearray:
        with self._lock:
            pool = self._free.get(n)
            if pool:
                return pool.pop()
        return bytearray(n)

    def _release(self, buf: bytearray) -> None:
        with self._lock:
            self._free.setdefault(len(buf), []).append(buf)

    def _put(self, key: Tuple[str, str], buf: bytearray) -> None:
        with self._lock:
            old = self.store.get(key)
            self.store[key] = buf
        if old is not None:
            self._release(old)

    def reserve(self, sizes: Iterable[int]) -> int:
        """Add a buffer of each size to the pool, every page touched;
        returns the bytes added."""
        total = 0
        for n in sizes:
            buf = bytearray(n)
            np.frombuffer(buf, dtype=np.uint8)[::_PAGE] = 1
            self._release(buf)
            total += n
        return total

    def sizes(self, bucket: str, prefix: str) -> List[int]:
        with self._lock:
            return [len(v) for k, v in self.store.items()
                    if k[0] == bucket and k[1].startswith(prefix)]

    # ------------------------------------------------------------ the S3 calls
    def put_object(self, Bucket, Key, Body):  # noqa: N803 - boto3's names
        start = Body.tell()
        n = Body.seek(0, io.SEEK_END) - start
        Body.seek(start)
        buf = self._buffer(n)
        view, got = memoryview(buf), 0
        while got < n:
            step = Body.readinto(view[got:])
            if not step:
                raise IOError(f"short body for {Key}: {got} of {n} bytes")
            got += step
        self._put((Bucket, Key), buf)

    def get_object(self, Bucket, Key, Range=None):  # noqa: N803
        data = memoryview(self.store[(Bucket, Key)])
        if Range is not None:
            lo, _, hi = Range[len("bytes="):].partition("-")
            data = data[int(lo):int(hi) + 1]  # HTTP ranges are inclusive
        return {"Body": _Body(data)}

    def head_object(self, Bucket, Key):  # noqa: N803
        return {"ContentLength": len(self.store[(Bucket, Key)])}

    def delete_object(self, Bucket, Key):  # noqa: N803
        with self._lock:
            buf = self.store.pop((Bucket, Key))
        self._release(buf)

    def create_multipart_upload(self, Bucket, Key):  # noqa: N803
        with self._lock:
            uid = f"upload-{self._next_upload}"
            self._next_upload += 1
            self._uploads[uid] = {}
        return {"UploadId": uid}

    def upload_part(self, Bucket, Key, UploadId, PartNumber, Body):  # noqa: N803
        data = Body.read()
        with self._lock:
            self._uploads[UploadId][PartNumber] = data
        return {"ETag": f"etag-{PartNumber}"}

    def complete_multipart_upload(self, Bucket, Key, UploadId, MultipartUpload):  # noqa: N803
        numbers = sorted(p["PartNumber"] for p in MultipartUpload["Parts"])
        with self._lock:
            pieces = self._uploads.pop(UploadId)
        buf = self._buffer(sum(len(pieces[n]) for n in numbers))
        pos = 0
        for n in numbers:
            buf[pos:pos + len(pieces[n])] = pieces[n]
            pos += len(pieces[n])
        self._put((Bucket, Key), buf)

    def abort_multipart_upload(self, Bucket, Key, UploadId):  # noqa: N803
        with self._lock:
            self._uploads.pop(UploadId, None)

    # ------------------------------------------------------------ the benchmark's
    def drop_prefix(self, bucket: str, prefix: str) -> int:
        """Delete every object of ``bucket`` under ``prefix``; returns the
        bytes freed to the pool."""
        with self._lock:
            doomed = [k for k in self.store if k[0] == bucket and k[1].startswith(prefix)]
            bufs = [self.store.pop(k) for k in doomed]
        for buf in bufs:
            self._release(buf)
        return sum(len(b) for b in bufs)
