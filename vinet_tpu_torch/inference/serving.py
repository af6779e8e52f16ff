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
"""

from __future__ import annotations

import numpy as np

from vinet_tpu_torch.inference.live import AVLiveStreamingPredictor, LiveStreamingPredictor


class MultiLiveServer(LiveStreamingPredictor):
    """S synchronized live streams through one advance and one decode."""

    def __init__(self, model, *, streams: int, **kw):
        if streams < 1:
            raise ValueError(f"streams must be >= 1, got {streams}")
        self.streams = int(streams)
        super().__init__(model, **kw)

    def feed(self, frames_u8: np.ndarray):
        """Feed (S, k, H, W, 3) uint8 frames, the same k for every stream;
        yields every (stream, frame, map) that became final."""
        frames_u8 = np.asarray(frames_u8)
        if frames_u8.ndim == 4:  # one frame per stream
            frames_u8 = frames_u8[:, None]
        if frames_u8.ndim != 5 or frames_u8.shape[0] != self.streams:
            raise ValueError(f"frames must be ({self.streams}, k, H, W, 3), "
                             f"got {frames_u8.shape}")
        yield from self._feed(frames_u8)

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
        self._take_audio(audio)
        yield from MultiLiveServer.feed(self, frames_u8)
