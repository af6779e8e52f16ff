"""The parity engine's audio path (``SlidingWindowPredictor.predict_video(...,
audio_fn=...)``) against vinet_tpu's: first with stub models that compute
the same order-sensitive function of the clip and the audio on both sides
(the warm-up reversal along samples, the cast, zero audio on padded rows),
then with AViNet(3, 32) at 32 x 32 (fixture visual weights, numpy-seeded
audio and fusion, f32; the model itself is held against JAX at 64 x 96 in
``test_torch_avinet.py``), both with BatchNorm folded. JAX's predictor runs
its own model function jitted with the trees as arguments
(``tests/torch_port_util.py::trees_as_arguments``).

Tolerances: stub maps 1e-5 (f32), uint8 maps within one level; AViNet maps
max|err| < 2e-3 (the port's parity anchor).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_util import (TORCH_THREADS, av_trees, jax_folded, port_avinet,
                                   trees_as_arguments)
from vinet_tpu.data.audio import audio_excerpt as jax_audio_excerpt
from vinet_tpu.inference.engine import SlidingWindowPredictor as JaxPredictor
from vinet_tpu_torch.data.audio import audio_excerpt
from vinet_tpu_torch.inference import SlidingWindowPredictor, window_plan
from vinet_tpu_torch.inference.accuracy import synthetic_audio_info

torch.set_num_threads(TORCH_THREADS)
L = 64  # stub excerpt length


def _order(a):
    """Per row: first half's mean minus second half's, which a reversal
    along the samples negates."""
    return a[:, : L // 2, 0].mean(1) - a[:, L // 2:, 0].mean(1)


class _JaxStub:
    def apply(self, params, state, x, audio):
        m = x.mean(axis=(1, 4)) + 3.0 * _order(audio)[:, None, None]
        return jax.nn.sigmoid(m), state


class _TorchStub(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, x, audio):
        self.seen.append(audio.clone())
        return torch.sigmoid(x.mean(dim=(1, 4)) + 3.0 * _order(audio)[:, None, None])


def _audio_fn(start):
    """A ramp by window start: every window's excerpt differs and has an order."""
    return (np.linspace(0.0, 1.0, L, dtype=np.float32)[:, None] * (1 + start % 5)
            + 0.01 * start)


@pytest.mark.parametrize("n,out_size,pad_short,quantize", [
    (13, None, False, False), (13, (30, 44), False, True), (5, (20, 30), True, True)])
def test_predict_video_audio_matches_jax_stub(n, out_size, pad_short, quantize):
    t, batch = 4, 3
    frames = np.random.default_rng(n).integers(0, 256, (n, 16, 24, 3), dtype=np.uint8)
    want = list(JaxPredictor(_JaxStub(), {}, {}, clip_size=t, batch=batch, dtype=jnp.float32)
                .predict_video(frames, out_size=out_size, pad_short=pad_short,
                               audio_fn=_audio_fn, quantize_u8=quantize))
    pred = SlidingWindowPredictor(_TorchStub(), clip_size=t, batch=batch, dtype=torch.float32,
                                  device="cpu")
    got = list(pred.predict_video(frames, out_size=out_size, pad_short=pad_short,
                                  audio_fn=_audio_fn, quantize_u8=quantize))
    assert [i for i, _ in got] == [i for i, _ in want] and len(got) == n
    for (_, g), (_, w) in zip(got, want):
        if quantize:
            assert g.dtype == np.uint8
            assert np.abs(g.astype(int) - np.asarray(w).astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
    # the last batch's padded rows got zero audio (the prepared copy saw it)
    pad = -len(window_plan(max(n, 2 * t - 1), t)) % batch
    assert pad > 0 and float(pred.model.seen[-1][batch - pad:].abs().max()) == 0.0


def test_predict_video_casts_audio_to_the_compute_dtype():
    pred = SlidingWindowPredictor(_TorchStub(), clip_size=4, batch=2, dtype=torch.bfloat16,
                                  device="cpu")
    list(pred.predict_video(np.zeros((7, 8, 8, 3), np.uint8), audio_fn=_audio_fn))
    assert pred.model.seen and all(a.dtype == torch.bfloat16 for a in pred.model.seen)


def test_av_parity_matches_jax():
    """A 63-frame video (the shortest a clip of 32 allows: 31 flipped
    warm-up windows and 32 normal ones), batch 16, with the windows'
    excerpts of a synthetic waveform: every map of JAX's predictor and the
    port's, f32."""
    model, params, state = av_trees(False, input_hw=(32, 32))
    n = 63
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 60, (n, 32, 32, 3)).astype(np.uint8)
    for f in range(n):
        frames[f, 4 + f % 16: 12 + f % 16, f % 24: 8 + f % 24] = 230
    info = synthetic_audio_info(n, fps=25.0, seed=2)
    jax_fn = lambda s: jax_audio_excerpt(info, 32, s)
    port_fn = lambda s: audio_excerpt(info, 32, s)
    jp = JaxPredictor(model, *jax_folded(params, state), clip_size=32, batch=16,
                      dtype=jnp.float32, fold=False)
    trees_as_arguments(jp, "model", jp._model_fn().__wrapped__)
    want = list(jp.predict_video(frames, audio_fn=jax_fn))
    pred = SlidingWindowPredictor(port_avinet(model, params, state), clip_size=32, batch=16,
                                  dtype=torch.float32, device="cpu")
    got = list(pred.predict_video(frames, audio_fn=port_fn))
    assert [i for i, _ in got] == [i for i, _ in want] and len(got) == n
    err = max(float(np.abs(g - np.asarray(w)).max()) for (_, g), (_, w) in zip(got, want))
    print(f"AV parity max|err| {err:.3g}")
    assert err < 2e-3
