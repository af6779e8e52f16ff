"""Multi-stream live serving: S synchronized video streams on one card,
``vinet_tpu/inference/serving.py`` (``MultiLiveServer`` for ViNet,
``AVMultiLiveServer`` for AViNet).

The JAX package vmaps the single-stream functions over a stream axis; here
the stream axis is folded into the batch axis. The advance runs the backbone
once on (S·P, C, T, H, W) for the S streams' phase timelines, and each
decode gathers the S streams' windows at the shared starts and runs S·Bw
windows through one decoder call and one launch of the head kernel. Every
stream's maps are what a dedicated ``LiveStreamingPredictor`` emits for its
frames: no op mixes batch elements.

Streams are synchronized: every feed delivers the same number of frames for
every stream; a stream that ends early is padded by the caller with its last
frame and the padding's maps dropped.

    server = MultiLiveServer(model, streams=4, micro=16)
    for frames in source:                      # (S, k, H, W, 3) uint8
        for s, idx, smap in server.feed(frames): ...
    for s, idx, smap in server.flush(): ...

``AVMultiLiveServer`` keeps one rolling sample buffer a stream
(``inference/live.py::AVLiveStreamingPredictor``'s) and folds the streams'
windows and their excerpts into the decode batch stream-major, as the
frames are.

``stream_mesh`` shards the streams over a mesh's data group
(``parallel/mesh.py``): rank r holds the device state of streams [r·S/d,
(r+1)·S/d) and advances only those; ``feed`` still takes every stream's
frames and yields every stream's maps, gathered from the ranks once per
decode. No other communication: the streams share nothing.
"""

from __future__ import annotations

import numpy as np

from vinet_tpu_torch.inference.live import AVLiveStreamingPredictor, LiveStreamingPredictor
from vinet_tpu_torch.parallel.mesh import batch_slice, gather_batch


class MultiLiveServer(LiveStreamingPredictor):
    """S synchronized live streams through one advance and one decode."""

    def __init__(self, model, *, streams: int, stream_mesh=None, **kw):
        """stream_mesh: shard the streams over its data axis (the module's
        docstring); streams must be divisible by it."""
        if streams < 1:
            raise ValueError(f"streams must be >= 1, got {streams}")
        if stream_mesh is not None and kw.get("mesh") is not None:
            raise ValueError("stream_mesh shards the stream axis; window-batch mesh "
                             "sharding (mesh=) cannot be combined with it")
        self.total_streams = int(streams)
        self.stream_mesh = stream_mesh
        self.stream_rows = batch_slice(stream_mesh, self.total_streams)  # this rank's streams
        self.streams = self.stream_rows.stop - self.stream_rows.start
        super().__init__(model, **kw)

    def _all_streams(self, maps):
        return gather_batch(maps, self.stream_mesh)

    def feed(self, frames_u8: np.ndarray):
        """Feed (S, k, H, W, 3) uint8 frames, the same k for every stream;
        yields every (stream, frame, map) that became final."""
        frames_u8 = np.asarray(frames_u8)
        if frames_u8.ndim == 4:  # one frame per stream
            frames_u8 = frames_u8[:, None]
        if frames_u8.ndim != 5 or frames_u8.shape[0] != self.total_streams:
            raise ValueError(f"frames must be ({self.total_streams}, k, H, W, 3), "
                             f"got {frames_u8.shape}")
        yield from self._feed(frames_u8[self.stream_rows])

    def flush(self):
        """Drain: each stream repeats its own last frame."""
        yield from self._flush()


class AVMultiLiveServer(AVLiveStreamingPredictor, MultiLiveServer):
    """S synchronized AViNet live streams:

        server = AVMultiLiveServer(model, streams=4, fps=30.0, micro=16)
        for frames, samples in source:    # (S, k, H, W, 3), S sample chunks
            for s, idx, smap in server.feed(frames, audio=samples): ...
        for s, idx, smap in server.flush(): ...
    """

    def feed(self, frames_u8: np.ndarray, audio=None):
        """Feed (S, k, H, W, 3) uint8 frames and, per stream, the 1-D chunk
        of samples that arrived with them (None: no audio this time);
        yields every (stream, frame, map) that became final."""
        if audio is not None:
            if len(audio) != self.total_streams:
                raise ValueError(f"{len(audio)} audio chunks for {self.total_streams} streams")
            audio = list(audio)[self.stream_rows]
        self._take_audio(audio)
        yield from MultiLiveServer.feed(self, frames_u8)
