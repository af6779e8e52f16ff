"""Parity-against-streaming accuracy on the synthetic fixtures,
``vinet_tpu/inference/accuracy.py`` (visual ViNet).

The exact sliding window of the reference's generate_result (parity,
``SlidingWindowPredictor``) against the chunked streaming encoder
(``StreamingPredictor``), each scored against the fixture's ground truth and
against each other with the CC metric (``metrics/saliency.py``), on the
videos of ``data/synthetic.py``. Both predictors end every decode in the
fused head kernel on the card. The dicts returned are the JAX package's, key
for key.

``synthetic_audio_info`` and ``evaluate_av_agreement`` (the audio-visual
model's agreement) wait for the audio-visual slice (``ROADMAP.md`` queue 1
item 5).
"""

from __future__ import annotations

import numpy as np
import torch

from vinet_tpu_torch.data.synthetic import FIXTURE_KINDS, make_eval_video, make_fixture_video
from vinet_tpu_torch.inference.engine import SlidingWindowPredictor
from vinet_tpu_torch.inference.streaming import StreamingPredictor
from vinet_tpu_torch.io.weights import load_model_weights
from vinet_tpu_torch.metrics.saliency import cc_score
from vinet_tpu_torch.models import ViNet


def _predictors(model, *, dtype, batch, chunk, device):
    common = dict(clip_size=model.clip_size, batch=batch, dtype=dtype, device=device)
    return (SlidingWindowPredictor(model, **common),
            StreamingPredictor(model, chunk=chunk, **common))


def evaluate_modes(model, *, n_frames=96, seeds=(100, 101), dtype=torch.bfloat16,
                   parity_stride=1, batch=16, chunk=128, device="cuda"):
    """Score parity and streaming inference against the blob video's GT.

    parity_stride > 1 scores every stride-th frame only (parity costs one
    whole-window forward a map); the streaming scores and the agreement
    cover the same frames, so the deltas stay like for like. Returns the
    means over all scored frames of all seeds: parity_cc, streaming_cc,
    cc_delta (streaming - parity), agreement_cc, and a row per seed."""
    par_pred, stm_pred = _predictors(model, dtype=dtype, batch=batch, chunk=chunk,
                                     device=device)
    rows = []
    p_all, s_all, a_all = [], [], []
    for seed in seeds:
        frames, gts = make_eval_video(n_frames=n_frames, seed=seed)
        par = dict(par_pred.predict_video(frames))
        stm = dict(stm_pred.predict_video(frames))
        idx = list(range(0, n_frames, parity_stride))
        p_cc = [cc_score(par[i], gts[i]) for i in idx]
        s_cc = [cc_score(stm[i], gts[i]) for i in idx]
        a_cc = [cc_score(stm[i], par[i]) for i in idx]
        rows.append({"seed": seed,
                     "parity_cc": float(np.mean(p_cc)),
                     "streaming_cc": float(np.mean(s_cc)),
                     "agreement_cc": float(np.mean(a_cc))})
        p_all += p_cc
        s_all += s_cc
        a_all += a_cc
    return {
        "n_frames": n_frames,
        "parity_stride": parity_stride,
        "frames_scored": len(p_all),
        "parity_cc": float(np.mean(p_all)),
        "streaming_cc": float(np.mean(s_all)),
        "cc_delta": float(np.mean(s_all) - np.mean(p_all)),
        "agreement_cc": float(np.mean(a_all)),
        "videos": rows,
    }


def evaluate_fixture_suite(model, *, kinds=None, n_frames=96, seed=100, dtype=torch.bfloat16,
                           batch=16, chunk=128, device="cuda"):
    """Score parity against streaming on every fixture kind. Returns a row
    per kind and the aggregates: cc_delta_min (the worst kind),
    cc_delta_mean and agreement_min."""
    kinds = FIXTURE_KINDS if kinds is None else kinds
    par_pred, stm_pred = _predictors(model, dtype=dtype, batch=batch, chunk=chunk,
                                     device=device)
    rows = []
    for kind in kinds:
        frames, gts = make_fixture_video(kind, n_frames=n_frames, seed=seed)
        par = dict(par_pred.predict_video(frames))
        stm = dict(stm_pred.predict_video(frames))
        p_cc = [cc_score(par[i], gts[i]) for i in range(n_frames)]
        s_cc = [cc_score(stm[i], gts[i]) for i in range(n_frames)]
        a_cc = [cc_score(stm[i], par[i]) for i in range(n_frames)]
        rows.append({"kind": kind,
                     "parity_cc": float(np.mean(p_cc)),
                     "streaming_cc": float(np.mean(s_cc)),
                     "cc_delta": float(np.mean(s_cc) - np.mean(p_cc)),
                     "agreement_cc": float(np.mean(a_cc))})
    deltas = [r["cc_delta"] for r in rows]
    return {
        "n_frames": n_frames,
        "fixtures": rows,
        "cc_delta_min": float(np.min(deltas)),
        "cc_delta_mean": float(np.mean(deltas)),
        "agreement_min": float(np.min([r["agreement_cc"] for r in rows])),
    }


def load_artifact(path) -> ViNet:
    """A committed fixture checkpoint (the JAX package's bf16 .npz, e.g.
    ``artifacts/streamft_fixture.npz``) as a ViNet(3, 32) in f32 on the CPU."""
    model = ViNet(num_hier=3, clip_size=32)
    return load_model_weights(model, str(path)).float()
