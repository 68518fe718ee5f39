"""The in-memory object store behind the S3 plugin: the calls the plugin
makes, buffers drawn from and returned to the pool, and a take and a
restore of the port through it."""

import torch

from portbench.store import MemoryS3Client


class _Stream:
    """A stand-in for the plugin's stream over a staged buffer."""

    def __init__(self, data):
        import io
        self.raw = io.BytesIO(data)
        self.tell, self.seek, self.readinto, self.read = (
            self.raw.tell, self.raw.seek, self.raw.readinto, self.raw.read)


def test_put_get_range_delete_and_reuse():
    c = MemoryS3Client()
    c.put_object(Bucket="b", Key="p/1/x", Body=_Stream(b"0123456789"))
    assert bytes(c.get_object(Bucket="b", Key="p/1/x")["Body"].read()) == b"0123456789"
    assert bytes(c.get_object(Bucket="b", Key="p/1/x", Range="bytes=2-4")["Body"].read()) == b"234"
    assert c.head_object(Bucket="b", Key="p/1/x")["ContentLength"] == 10
    buf = c.store[("b", "p/1/x")]
    assert c.drop_prefix("b", "p/1/") == 10 and not c.store
    c.put_object(Bucket="b", Key="p/2/x", Body=_Stream(b"abcdefghij"))
    assert c.store[("b", "p/2/x")] is buf  # drawn from the pool
    c.delete_object(Bucket="b", Key="p/2/x")
    assert c.reserve([10, 3]) == 13
    assert sorted(len(b) for v in c._free.values() for b in v) == [3, 10, 10]


def test_multipart_assembles_in_order():
    c = MemoryS3Client()
    uid = c.create_multipart_upload(Bucket="b", Key="k")["UploadId"]
    for n, part in ((2, b"world"), (1, b"hello ")):
        c.upload_part(Bucket="b", Key="k", UploadId=uid, PartNumber=n, Body=_Stream(part))
    c.complete_multipart_upload(Bucket="b", Key="k", UploadId=uid,
                                MultipartUpload={"Parts": [{"PartNumber": 2}, {"PartNumber": 1}]})
    assert bytes(c.store[("b", "k")]) == b"hello world"


def test_the_port_takes_and_restores_through_it():
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    c = MemoryS3Client()
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(300, 70, generator=g), "n": torch.arange(5)}
    want = {k: v.clone() for k, v in state.items()}
    Snapshot.async_take("s3://b/run/1", {"m": StateDict(state)},
                        storage_options={"client": c}).wait()
    for v in state.values():
        v.zero_()
    Snapshot("s3://b/run/1", storage_options={"client": c}).restore({"m": StateDict(state)})
    assert all(torch.equal(state[k], want[k]) for k in want)
