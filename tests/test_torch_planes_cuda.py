"""The attribution, forensics and cloud planes on the card.

- A streamed take of a CUDA tensor records ``sub_chunk_dtoh`` spans (the
  DtoH copy into a pinned slab on the side stream) and the restore
  ``sub_chunk_htod`` spans; the critical-path attribution puts the first in
  ``stage_copy`` and the second in ``decode``.
- A thread parked in a CUDA event wait inside the device seam
  (``io_preparers/array.py``) classifies as ``stage_copy``.
- A multipart upload of a CUDA tensor hands the S3 client memoryviews of
  the pinned staging buffer, with no copy, and a retried part re-reads the
  same bytes from its first.

These tests need an NVIDIA GPU; elsewhere they skip. Run them on the card
without the suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_planes_cuda.py
"""

from __future__ import annotations

import json
import os
import threading

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch import faultinject, scheduler, telemetry
from torchsnapshot_tpu_torch.storage_plugins import s3 as s3_mod
from torchsnapshot_tpu_torch.storage_plugins.retry import CollectiveRetryStrategy
from torchsnapshot_tpu_torch.telemetry import critpath, forensics
from torchsnapshot_tpu_torch.test_utils import FakeS3Client
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _planes():
    scheduler.reset_io_governor()
    yield
    faultinject.disable()
    telemetry.set_enabled(False)
    telemetry.refresh_from_env()
    scheduler.reset_io_governor()


def test_dtoh_is_stage_copy_and_htod_is_decode(card, tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES", str(1 << 20))
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "always")
    telemetry.set_enabled(True)
    w = torch.randn(4 << 20, device=card)  # 16 MiB: 16 sub-chunks
    path = str(tmp_path / "s")
    P.Snapshot.take(path, {"m": P.StateDict(w=w)})
    take = telemetry.last_summary()
    take_attr = telemetry.last_attribution()
    dst = torch.zeros_like(w)
    P.Snapshot(path).restore({"m": P.StateDict(w=dst)})
    restore_attr = telemetry.last_attribution()
    assert torch.equal(dst, w)
    assert take is not None
    assert critpath.SPAN_CATEGORIES["sub_chunk_dtoh"] == "stage_copy"
    assert critpath.SPAN_CATEGORIES["sub_chunk_htod"] == "decode"
    assert take_attr["categories"].get("stage_copy", 0) > 0
    assert restore_attr["categories"].get("decode", 0) > 0
    # The take's spans are in its Chrome trace (a finished op's events
    # leave the bus); the restore's are still on the bus.
    with open(os.path.join(path, telemetry.trace_path_for_rank(0))) as f:
        traced = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "sub_chunk_dtoh" in traced
    names = {e.get("name") for e in telemetry.events() if e.get("ph") == "span"}
    assert "sub_chunk_htod" in names


def test_a_thread_waiting_on_a_cuda_event_in_the_device_seam_is_stage_copy(card) -> None:
    from torchsnapshot_tpu_torch.io_preparers import array

    started, release = threading.Event(), threading.Event()
    side = torch.cuda.Stream()

    def park() -> None:
        # A long device copy on the side stream, and the wait for its
        # event from a frame of the device seam's module.
        src = torch.randn(64 << 20, device=card)
        with torch.cuda.stream(side):
            for _ in range(20):
                src.mul_(1.0001)
            event = torch.cuda.Event()
            event.record(side)
        started.set()
        code = compile("event.synchronize(); release.wait(10)", array.__file__, "exec")
        exec(code, {"event": event, "release": release})

    t = threading.Thread(target=park, name="seam-wait")
    t.start()
    try:
        assert started.wait(30)
        threads = {th["name"]: th for th in forensics.sample_stacks()}
        parked = threads["seam-wait"]
        assert parked["category"] == "stage_copy"
        assert parked["leaf"].startswith("io_preparers/array.py")
    finally:
        release.set()
        t.join(30)


def test_multipart_upload_of_a_cuda_tensor_is_zero_copy_from_pinned_memory(
    card, monkeypatch
) -> None:
    monkeypatch.setattr(s3_mod, "MULTIPART_PART_BYTES", 1 << 20)
    pinned, first_bytes = [], {}

    class Spy(FakeS3Client):
        def upload_part(self, Bucket, Key, UploadId, PartNumber, Body):  # noqa: N803
            view = torch.frombuffer(Body._mv, dtype=torch.uint8)
            pinned.append(view.is_pinned())
            first_bytes.setdefault(PartNumber, []).append(bytes(Body._mv[:16]))
            return super().upload_part(Bucket, Key, UploadId, PartNumber, Body)

    client = Spy(fail_part_numbers=[2])
    w = torch.randn(1 << 20, device=card)  # 4 MiB: 4 parts
    opts = {"client": client, "multipart_threshold": 1 << 20,
            "retry_strategy": CollectiveRetryStrategy(base_backoff_s=0.01)}
    P.Snapshot.take("s3://bucket/zc", {"m": P.StateDict(w=w)}, storage_options=opts)
    assert pinned and all(pinned)
    # The retried part was read again from its first byte.
    assert len(first_bytes[2]) == 2 and first_bytes[2][0] == first_bytes[2][1]
    dst = torch.zeros_like(w)
    P.Snapshot("s3://bucket/zc", storage_options=opts).restore({"m": P.StateDict(w=dst)})
    assert torch.equal(dst, w)
