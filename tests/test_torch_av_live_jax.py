"""vinet_tpu_torch's AVLiveStreamingPredictor against vinet_tpu's, fed the
same frames and sample chunks the same way: AViNet(3, 32) with the
refinement encoder at 32 x 32 (fixture visual weights, numpy-seeded audio
and fusion, ``tests/torch_port_util.py::av_trees``), f32 on the CPU, BatchNorm
folded on both sides.

JAX's server runs its own advance, timeline and decode functions jitted
with the trees as arguments (``tests/torch_port_util.py::trees_as_arguments``;
the advance is built inside the traced function, since it takes the
backbone's trees when it is built).

Tolerance: max|err| < 2e-3 on every frame (the port's anchor); the rolling
sample buffers are trimmed to the same sample.
"""

import numpy as np
import torch

import jax.numpy as jnp

from tests.test_torch_av_live import FPS, FS, HW, _feed_all, _frames
from tests.torch_port_util import (TORCH_THREADS, av_trees, jax_folded, port_avinet,
                                   trees_as_arguments)
from vinet_tpu.inference.live import AVLiveStreamingPredictor as JaxAVLive
from vinet_tpu_torch.inference import AVLiveStreamingPredictor
from vinet_tpu_torch.inference.accuracy import synthetic_audio_info

torch.set_num_threads(TORCH_THREADS)
LIVE = dict(fps=FPS, audio_fs=FS, batch=8, micro=16, span=168, warmup_chunk=64)


def test_av_live_matches_jax():
    """72 frames in feeds of 16 with their samples on the stream clock, the
    rest of the samples, then the flush: the warm-up pass, live decodes and
    the drain all meet JAX's."""
    model, params, state = av_trees(True, input_hw=HW)
    n = 72
    frames = _frames(n, 5)
    wav = synthetic_audio_info(n, fps=FPS, fs=FS, seed=6).wav[0]
    jp = JaxAVLive(model, *jax_folded(params, state), dtype=jnp.float32, fold=False, **LIVE)
    trees_as_arguments(jp, "advance", lambda tails, bufs, f: jp._build_advance()(tails, bufs, f))
    trees_as_arguments(jp, "timeline", jp._build_timeline())
    trees_as_arguments(jp, "decode", jp._build_decode())
    want = _feed_all(jp, frames, [wav])
    port = AVLiveStreamingPredictor(port_avinet(model, params, state), dtype=torch.float32,
                                    device="cpu", **LIVE)
    got = _feed_all(port, frames, [wav])
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(n))
    err = max(float(np.abs(g - np.asarray(w)).max()) for (_, g), (_, w) in zip(got, want))
    print(f"AV live max|err| {err:.3g}")
    assert err < 2e-3
    assert port._samples_base == [jp._samples_base] and jp._samples_base > 0
