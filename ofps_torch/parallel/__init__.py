"""Multi-stream batching and device meshes (port of ``ofps_tpu.parallel``):
``StreamPipeline`` over B streams, spread by ``shardings=`` over a
("stream", "space") mesh of devices (:mod:`.sharding`, :mod:`.spatial`),
and several processes (:mod:`.distributed`)."""

from ofps_torch.parallel.sharding import (
    StreamSharding,
    make_stream_mesh,
    shard_put,
    stream_sharding,
)
from ofps_torch.parallel.stream import StreamOutputs, StreamPipeline, StreamState

__all__ = [
    "StreamSharding",
    "make_stream_mesh",
    "shard_put",
    "stream_sharding",
    "StreamOutputs",
    "StreamPipeline",
    "StreamState",
]
