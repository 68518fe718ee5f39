"""The port's S3 and GCS plugins and ``MemoryviewStream`` against the JAX
package's, over in-memory clients (no SDK, no network).

Each plugin-level case runs on both packages' plugins with the same fake
client and must give the same bytes and the same client calls: round
trips, ranged and chunked reads, a retried upload rewound to its first
byte, multipart uploads (a retried part re-read from its first byte, an
abort on a permanent failure), transfers on the cloud-I/O pool, and the
errors that propagate. Snapshots interchange: what the port takes through
a fake S3 or GCS store, the JAX package restores bit-exact from the same
objects, and the other way round. ``s3://``, ``gs://`` and ``gcs://``
resolve to the port's plugins, other schemes to the entry-point group, and
without a client the plugins raise the JAX package's error naming the SDK.
"""

from __future__ import annotations

import asyncio
import io
import sys
import threading

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu import faultinject as jax_faultinject
from torchsnapshot_tpu import io_types as jax_io
from torchsnapshot_tpu import memoryview_stream as jax_mvs
from torchsnapshot_tpu.storage_plugins import gcs as jax_gcs
from torchsnapshot_tpu.storage_plugins import retry as jax_retry
from torchsnapshot_tpu.storage_plugins import s3 as jax_s3
from torchsnapshot_tpu_torch import faultinject, io_types, memoryview_stream, storage_plugin
from torchsnapshot_tpu_torch.storage_plugins import gcs, retry, s3
from torchsnapshot_tpu_torch.test_utils import FakeGCSBucket, FakeS3Client
from torch_test_env import autotune_never  # noqa: F401 - autouse

# package -> (io_types, retry, s3, gcs)
PKGS = {"port": (io_types, retry, s3, gcs), "jax": (jax_io, jax_retry, jax_s3, jax_gcs)}


@pytest.fixture(autouse=True)
def _clean():
    yield
    faultinject.disable()
    jax_faultinject.disable()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ------------------------------------------------------- memoryview stream


@pytest.mark.parametrize("module", [memoryview_stream, jax_mvs], ids=["port", "jax"])
def test_memoryview_stream_reads_seeks_and_closes_alike(module) -> None:
    data = bytes(range(100))
    steps = []
    for stream in (module.MemoryviewStream(memoryview(data)),
                   jax_mvs.MemoryviewStream(memoryview(data))):
        out = [stream.read(10), stream.tell(), stream.seek(5, io.SEEK_CUR),
               stream.read(3), stream.seek(-4, io.SEEK_END), stream.read(), stream.read(1),
               stream.seek(0), len(stream), stream.readable(), stream.seekable(),
               stream.writable()]
        buf = bytearray(7)
        stream.seek(95)
        out += [stream.readinto(buf), bytes(buf)]
        with pytest.raises(ValueError):
            stream.seek(-1)
        stream.close()
        with pytest.raises(ValueError):
            stream.read()
        steps.append(out)
    assert steps[0] == steps[1]
    # A 2-D view streams its bytes without a copy.
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    stream = module.MemoryviewStream(memoryview(arr))
    assert stream.read() == arr.tobytes() and stream._mv.obj is arr


# ----------------------------------------------------------- plugin cases


def _s3(pkg: str, client, **options):
    return PKGS[pkg][2].S3StoragePlugin("fake-bucket/prefix",
                                        storage_options={"client": client, **options})


def _gcs(pkg: str, bucket, **options):
    return PKGS[pkg][3].GCSStoragePlugin("fake-bucket/prefix",
                                         storage_options={"bucket": bucket, **options})


def _fast(pkg: str):
    return PKGS[pkg][1].CollectiveRetryStrategy(base_backoff_s=0.001)


def _case_s3_round_trip(pkg):
    io_mod, client = PKGS[pkg][0], FakeS3Client()
    plugin = _s3(pkg, client)
    payload = bytes(range(256)) * 100
    run(plugin.write(io_mod.WriteIO(path="0/m/w", buf=memoryview(payload))))
    read_io = io_mod.ReadIO(path="0/m/w", byte_range=(100, 300))
    run(plugin.read(read_io))
    full = io_mod.ReadIO(path="0/m/w")
    run(plugin.read(full))
    run(plugin.delete("0/m/w"))
    return bytes(read_io.buf), bytes(full.buf) == payload, client.get_ranges, client.store


def _case_s3_rewind_on_retry(pkg):
    client = FakeS3Client(fail_times=2)
    plugin = _s3(pkg, client, retry_strategy=_fast(pkg))
    run(plugin.write(PKGS[pkg][0].WriteIO(path="w", buf=memoryview(b"x" * 10_000))))
    return client.put_attempts, client.store


def _case_s3_multipart(pkg, monkeypatch):
    monkeypatch.setattr(PKGS[pkg][2], "MULTIPART_PART_BYTES", 1024)
    client = FakeS3Client(fail_part_numbers=[2])
    plugin = _s3(pkg, client, multipart_threshold=2048, retry_strategy=_fast(pkg))
    data = np.random.default_rng(0).integers(0, 255, 5000, np.uint8).tobytes()
    run(plugin.write(PKGS[pkg][0].WriteIO(path="big", buf=memoryview(data))))
    read_io = PKGS[pkg][0].ReadIO(path="big")
    run(plugin.read(read_io))
    return (client.part_attempts, client.parts_completed, client.uploads, bytes(read_io.buf)
            == data, client.store)


def _case_s3_multipart_abort(pkg, monkeypatch):
    monkeypatch.setattr(PKGS[pkg][2], "MULTIPART_PART_BYTES", 1024)

    class Poison(FakeS3Client):
        def upload_part(self, Bucket, Key, UploadId, PartNumber, Body):  # noqa: N803
            if PartNumber == 2:
                raise ValueError("permanent")
            return super().upload_part(Bucket, Key, UploadId, PartNumber, Body)

    client = Poison()
    plugin = _s3(pkg, client, multipart_threshold=2048)
    with pytest.raises(ValueError, match="permanent"):
        run(plugin.write(PKGS[pkg][0].WriteIO(path="bad", buf=memoryview(b"z" * 3000))))
    return client.aborted, client.store


def _case_s3_errors(pkg, monkeypatch):
    monkeypatch.setattr(PKGS[pkg][2], "RANGED_READ_CHUNK_BYTES", 1024)
    client = FakeS3Client()
    plugin = _s3(pkg, client)
    with pytest.raises(KeyError):
        run(plugin.read(PKGS[pkg][0].ReadIO(path="missing")))
    data = np.random.default_rng(1).integers(0, 255, 10_000, np.uint8).tobytes()
    run(plugin.write(PKGS[pkg][0].WriteIO(path="r", buf=memoryview(data))))
    read_io = PKGS[pkg][0].ReadIO(path="r", byte_range=(500, 9_500))
    run(plugin.read(read_io))
    short = FakeS3Client()
    short.store = dict(client.store)
    orig = short.get_object

    def truncated(Bucket, Key, Range=None):  # noqa: N803
        body = orig(Bucket, Key, Range)["Body"].read()[:-1]
        return {"Body": type("B", (), {"read": lambda self: body})()}

    short.get_object = truncated
    with pytest.raises(IOError, match="short read"):
        run(_s3(pkg, short).read(PKGS[pkg][0].ReadIO(path="r", byte_range=(0, 8_000))))
    return bytes(read_io.buf) == data[500:9_500], sorted(client.get_ranges)


def _case_s3_cloud_pool(pkg):
    seen = []

    class Recording(FakeS3Client):
        def put_object(self, Bucket, Key, Body):  # noqa: N803
            # Each package names its own pool (tsnap-gpu-cloud-io here).
            name = threading.current_thread().name
            seen.append(name.startswith("tsnap-") and "cloud-io" in name)
            return super().put_object(Bucket, Key, Body)

    run(_s3(pkg, Recording()).write(PKGS[pkg][0].WriteIO(path="t", buf=memoryview(b"x" * 64))))
    return seen


def _case_gcs_round_trip(pkg):
    bucket = FakeGCSBucket()
    plugin = _gcs(pkg, bucket, chunk_size_bytes=512)
    payload = bytes([i % 251 for i in range(4096)])
    run(plugin.write(PKGS[pkg][0].WriteIO(path="r", buf=memoryview(payload))))
    full = PKGS[pkg][0].ReadIO(path="r")
    run(plugin.read(full))
    ranged = PKGS[pkg][0].ReadIO(path="r", byte_range=(100, 2100))
    run(plugin.read(ranged))
    blob = bucket.blob("prefix/r")
    return (bytes(full.buf) == payload, bytes(ranged.buf) == payload[100:2100],
            sorted(blob.download_calls), blob.chunk_size, bucket.store)


def _case_gcs_rewind_on_retry(pkg):
    bucket = FakeGCSBucket(fail_times=2)
    plugin = _gcs(pkg, bucket, retry_strategy=_fast(pkg))
    run(plugin.write(PKGS[pkg][0].WriteIO(path="u", buf=memoryview(b"y" * 3000))))
    with pytest.raises(KeyError):
        run(_gcs(pkg, FakeGCSBucket()).read(PKGS[pkg][0].ReadIO(path="missing")))
    return bucket.blob("prefix/u").upload_attempts, bucket.store


_CASES = {
    "s3 round trip": _case_s3_round_trip, "s3 rewind on retry": _case_s3_rewind_on_retry,
    "s3 multipart": _case_s3_multipart, "s3 multipart abort": _case_s3_multipart_abort,
    "s3 errors": _case_s3_errors, "s3 cloud pool": _case_s3_cloud_pool,
    "gcs round trip": _case_gcs_round_trip, "gcs rewind on retry": _case_gcs_rewind_on_retry,
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_both_packages_plugins_do_the_same(case, monkeypatch) -> None:
    fn = _CASES[case]
    args = (monkeypatch,) if fn.__code__.co_argcount == 2 else ()
    mine, theirs = fn("port", *args), fn("jax", *args)
    assert mine == theirs
    assert mine  # each case returns what it observed


def test_the_fault_sites_are_the_jax_packages() -> None:
    for name in ("s3.put", "s3.put_part", "s3.get", "gcs.resumable_feed", "gcs.get"):
        assert faultinject.SITES[name] == jax_faultinject.SITES[name] == "data"


def test_an_injected_transient_fault_is_retried_once(monkeypatch) -> None:
    monkeypatch.setattr(s3, "MULTIPART_PART_BYTES", 1024)
    client = FakeS3Client()
    strategy = retry.CollectiveRetryStrategy(base_backoff_s=0.001)
    plugin = _s3("port", client, multipart_threshold=2048, retry_strategy=strategy)
    faultinject.configure("s3.put_part@2=transient;s3.get@1=transient")
    data = bytes(range(256)) * 20
    run(plugin.write(io_types.WriteIO(path="p", buf=memoryview(data))))
    read_io = io_types.ReadIO(path="p")
    run(plugin.read(read_io))
    assert bytes(read_io.buf) == data and strategy.fleet_attempts == 2
    assert faultinject.hits() == {"s3.put_part": 6, "s3.get": 2}


# ------------------------------------------------ snapshots across packages


def _state(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 48)).astype(np.float32),
            "b": rng.integers(0, 1 << 30, 1000).astype(np.int64), "step": seed}


def _options(scheme: str, store):
    return {"client": store} if scheme == "s3" else {"bucket": store}


@pytest.mark.parametrize("scheme", ["s3", "gs"])
@pytest.mark.parametrize("taker", ["port", "jax"])
def test_a_snapshot_through_a_fake_store_restores_bit_exact_in_both(scheme, taker,
                                                                    monkeypatch) -> None:
    """Large leaves go multipart (S3) or resumable (GCS) on both sides."""
    for mod in (s3, jax_s3):
        monkeypatch.setattr(mod, "MULTIPART_PART_BYTES", 8 << 10)
    store = FakeS3Client() if scheme == "s3" else FakeGCSBucket()
    options = dict(_options(scheme, store), multipart_threshold=8 << 10, chunk_size_bytes=8 << 10)
    url = f"{scheme}://bucket/ckpt"
    src = _state(3)
    if taker == "port":
        P.Snapshot.take(url, {"m": P.StateDict(w=torch.from_numpy(src["w"]),
                                               b=torch.from_numpy(src["b"]), step=src["step"])},
                        storage_options=options)
    else:
        J.Snapshot.take(url, {"m": J.StateDict(**src)}, storage_options=options)
    port_dst = P.StateDict(w=torch.zeros(64, 48), b=torch.zeros(1000, dtype=torch.int64),
                           step=-1)
    P.Snapshot(url, storage_options=options).restore({"m": port_dst})
    jax_dst = J.StateDict(w=np.zeros((64, 48), np.float32), b=np.zeros(1000, np.int64), step=-1)
    J.Snapshot(url, storage_options=options).restore({"m": jax_dst})
    assert np.array_equal(port_dst["w"].numpy(), src["w"])
    assert np.array_equal(port_dst["b"].numpy(), src["b"])
    assert np.array_equal(np.asarray(jax_dst["w"]), src["w"])
    assert np.array_equal(np.asarray(jax_dst["b"]), src["b"])
    assert port_dst["step"] == jax_dst["step"] == 3
    if scheme == "s3":
        assert store.parts_completed == 2  # w: 12,288 B in 2 parts; b: 8,000 B one PUT
    else:
        assert any(b.chunk_size == 8 << 10 for b in store.blobs.values())


# ------------------------------------------------------------- resolution


def test_schemes_resolve_to_the_ports_plugins(monkeypatch) -> None:
    client, bucket = FakeS3Client(), FakeGCSBucket()
    assert isinstance(storage_plugin.url_to_storage_plugin("s3://b/x", {"client": client}),
                      s3.S3StoragePlugin)
    for scheme in ("gs", "gcs"):
        plugin = storage_plugin.url_to_storage_plugin(f"{scheme}://b/x", {"bucket": bucket})
        assert isinstance(plugin, gcs.GCSStoragePlugin) and plugin.prefix == "x"

    class EP:
        name = "mem"

        @staticmethod
        def load():
            return lambda root, storage_options: ("mem plugin", root, storage_options)

    groups = []

    def entry_points():
        return type("EPs", (), {"select": lambda self, group: groups.append(group) or [EP]})()

    monkeypatch.setattr(storage_plugin, "entry_points", entry_points)
    assert storage_plugin.url_to_storage_plugin("mem://a/b", {"k": 1}) == ("mem plugin", "a/b",
                                                                           {"k": 1})
    assert groups == [storage_plugin.ENTRY_POINT_GROUP] == ["torchsnapshot_tpu_torch.storage_plugins"]
    with pytest.raises(RuntimeError, match="Failed to resolve storage plugin for protocol 'nope'"):
        storage_plugin.url_to_storage_plugin("nope://a")


@pytest.mark.parametrize("scheme,package", [("s3", "boto3"), ("gs", "google-cloud-storage")])
def test_without_a_client_the_plugin_names_the_missing_sdk(monkeypatch, scheme, package) -> None:
    monkeypatch.setitem(sys.modules, "boto3", None)
    monkeypatch.setitem(sys.modules, "google.cloud.storage", None)
    google_cloud = sys.modules.get("google.cloud")
    if google_cloud is not None and hasattr(google_cloud, "storage"):
        monkeypatch.delattr(google_cloud, "storage")
    errors = []
    for resolve in (storage_plugin.url_to_storage_plugin,
                    __import__("torchsnapshot_tpu.storage_plugin",
                               fromlist=["x"]).url_to_storage_plugin):
        with pytest.raises(RuntimeError, match=package) as info:
            resolve(f"{scheme}://bucket/x")
        errors.append(str(info.value))
    assert errors[0] == errors[1]
