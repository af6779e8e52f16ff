"""vinet_tpu_torch's AVMultiLiveServer against vinet_tpu's, fed the same
frames and per-stream sample chunks the same way: two streams, one with
audio and one silent, AViNet(3, 32) at 32 x 32 (fixture visual weights,
numpy-seeded audio and fusion, ``tests/torch_port_util.py::av_trees``), f32
on the CPU, BatchNorm folded on both sides. Each stream's excerpts enter
the decode batch stream-major in the port and through a vmap over streams
in JAX, so a mixed-up stream shows as a wrong map.

JAX's server runs its vmapped advance, timeline and decode functions jitted
with the trees as arguments (``tests/torch_port_util.py::trees_as_arguments``),
composed as ``vinet_tpu/inference/serving.py`` composes them.

Tolerance: max|err| < 2e-3 on every frame of every stream (the port's
anchor); the per-stream sample buffers are trimmed to the same sample.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_av_live import FPS, FS, HW, _feed_all, _frames
from tests.torch_port_util import (TORCH_THREADS, av_trees, jax_folded, port_avinet,
                                   trees_as_arguments)
from vinet_tpu.inference.serving import AVMultiLiveServer as JaxAVMultiLiveServer
from vinet_tpu_torch.inference import AVMultiLiveServer
from vinet_tpu_torch.inference.accuracy import synthetic_audio_info

torch.set_num_threads(TORCH_THREADS)
LIVE = dict(fps=FPS, audio_fs=FS, batch=8, micro=16, span=168, warmup_chunk=64)


def _per_stream(got, streams, n):
    out = []
    for s in range(streams):
        mine = [(i, m) for si, i, m in got if si == s]
        assert [i for i, _ in mine] == list(range(n)), s  # every frame once, in order
        out.append(dict(mine))
    return out


def test_av_multilive_matches_jax():
    model, params, state = av_trees(False, input_hw=HW)
    n = 72
    frames = np.stack([_frames(n, 3), _frames(n, 11)])
    wavs = [synthetic_audio_info(n, fps=FPS, fs=FS, seed=5).wav[0], np.zeros((0,), np.float32)]
    jm = JaxAVMultiLiveServer(model, *jax_folded(params, state), streams=2, dtype=jnp.float32,
                              fold=False, **LIVE)
    trees_as_arguments(jm, "advance",
                       lambda tails, bufs, f: jax.vmap(jm._build_advance())(tails, bufs, f))
    trees_as_arguments(jm, "timeline", lambda f, flip: jax.vmap(
        jm._build_timeline(), in_axes=(0, None))(f, flip))
    trees_as_arguments(jm, "decode", lambda tl, dn, st, audio: jax.vmap(
        jm._build_decode(), in_axes=(0, 0, None, 0))(tl, dn, st, audio))
    want = _per_stream(_feed_all(jm, frames, wavs), 2, n)
    port = AVMultiLiveServer(port_avinet(model, params, state), streams=2, dtype=torch.float32,
                             device="cpu", **LIVE)
    got = _per_stream(_feed_all(port, frames, wavs), 2, n)
    err = max(float(np.abs(got[s][i] - np.asarray(want[s][i])).max())
              for s in range(2) for i in range(n))
    print(f"AV multi-stream max|err| {err:.3g}")
    assert err < 2e-3
    assert port._samples_base == jm._samples_base and min(jm._samples_base) > 0
