"""Parity-against-streaming accuracy on the synthetic fixtures,
``vinet_tpu/inference/accuracy.py`` (visual ViNet).

The exact sliding window of the reference's generate_result (parity,
``SlidingWindowPredictor``) against the chunked streaming encoder
(``StreamingPredictor``), each scored against the fixture's ground truth and
against each other with the CC metric (``metrics/saliency.py``), on the
videos of ``data/synthetic.py``. Both predictors end every decode in the
fused head kernel on the card. The dicts returned are the JAX package's, key
for key.

``evaluate_av_agreement`` runs AViNet both ways on the same fixtures, each
window with its excerpt of a ``synthetic_audio_info`` waveform, and scores
their agreement only: with a visual fixture checkpoint the fusion branch is
seeded, and CC against ground truth of an untrained fusion is noise.
``av_fixture_model`` builds such an AViNet (or, with fusion, an
AViNetFusion): the visual branch from the fixture, the audio and fusion
weights from a numpy seed.
"""

from __future__ import annotations

import numpy as np
import torch

from vinet_tpu_torch.data.audio import AudioInfo, audio_excerpt, frame_sample_ranges
from vinet_tpu_torch.data.synthetic import FIXTURE_KINDS, make_eval_video, make_fixture_video
from vinet_tpu_torch.inference.engine import SlidingWindowPredictor
from vinet_tpu_torch.inference.streaming import AVStreamingPredictor, StreamingPredictor
from vinet_tpu_torch.io.weights import load_model_weights
from vinet_tpu_torch.metrics.saliency import cc_score
from vinet_tpu_torch.models import AViNet, AViNetFusion, ViNet


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


def synthetic_audio_info(n_frames, *, fps=30.0, fs=22050, seed=0) -> AudioInfo:
    """A seeded waveform (a chirp and noise) indexed like a dataset's wav,
    for AV evaluation without audio files."""
    n = int(n_frames / fps * fs) + fs // 10
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / fs
    wav = (0.05 * np.sin(2 * np.pi * (220 + 40 * t) * t)
           + 0.01 * rng.standard_normal(n)).astype(np.float32)[None]
    starts, ends = frame_sample_ranges(n, n_frames, fs, fps)
    return AudioInfo(wav=wav, fs=fs, starts=starts, ends=ends)


def evaluate_av_agreement(model, *, kinds=None, n_frames=96, seed=100, dtype=torch.bfloat16,
                          batch=16, chunk=128, device="cuda"):
    """Streaming against parity agreement (CC) of an AViNet on the fixture
    suite, both with the same per-window excerpts of kind i's
    ``synthetic_audio_info(seed=i)``. Returns a row per kind and
    agreement_min, agreement_mean."""
    kinds = FIXTURE_KINDS if kinds is None else kinds
    common = dict(clip_size=model.clip_size, batch=batch, dtype=dtype, device=device)
    par_pred = SlidingWindowPredictor(model, **common)
    stm_pred = AVStreamingPredictor(model, chunk=chunk, **common)
    rows = []
    for k_i, kind in enumerate(kinds):
        frames, _ = make_fixture_video(kind, n_frames=n_frames, seed=seed)
        info = synthetic_audio_info(n_frames, seed=k_i)
        audio_fn = lambda s, _info=info: audio_excerpt(_info, model.clip_size, s)
        par = dict(par_pred.predict_video(frames, audio_fn=audio_fn))
        stm = dict(stm_pred.predict_video(frames, audio_fn=audio_fn))
        a_cc = [cc_score(stm[i], par[i]) for i in range(n_frames)]
        rows.append({"kind": kind, "agreement_cc": float(np.mean(a_cc))})
    return {
        "n_frames": n_frames,
        "fixtures": rows,
        "agreement_min": float(np.min([r["agreement_cc"] for r in rows])),
        "agreement_mean": float(np.mean([r["agreement_cc"] for r in rows])),
    }


def seeded_av_leaves(model: torch.nn.Module, seed: int = 0) -> dict:
    """Numpy-seeded values for every tensor of an AViNet or AViNetFusion (or
    of one of their modules) outside the visual model, by name, drawn in the order of the
    sorted names: conv, linear and bilinear weights N(0, 1/fan_in), their
    biases N(0, 0.01²); BatchNorm and LayerNorm weight 1 + N(0, 0.01) and
    bias N(0, 0.01), BatchNorm mean N(0, 0.01) and var 1 + |N(0, 0.01)|. The
    sin/cos table and the BatchNorm counters are left out. The CPU tests
    draw their AViNet weights here too (``tests/torch_port_util.py::av_trees``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in sorted(model.state_dict().items()):
        if name.startswith("visual_model.") or name.endswith(("num_batches_tracked", ".pe")):
            continue
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)
        holder, leaf = leaf[0].rsplit(".", 1)[-1], leaf[1]
        v = rng.standard_normal(shape)
        if holder.startswith(("norm", "batchnorm")):
            v = {"weight": 1.0 + 0.1 * v, "running_var": 1.0 + np.abs(0.1 * v)}.get(leaf, 0.1 * v)
        elif len(shape) > 1:
            v = v / np.sqrt(np.prod(shape[1:]))
        else:
            v = 0.01 * v
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


def av_fixture_model(path, *, seed: int = 0, use_transformer: bool = False,
                     input_hw=(224, 384), fusion: bool = False) -> AViNet | AViNetFusion:
    """AViNet(3, 32), or with fusion AViNetFusion(512) (use_transformer
    does not apply), in f32 on the CPU: the visual model from a committed
    fixture checkpoint (``load_artifact``), the rest ``seeded_av_leaves``,
    loaded strictly: only the sin/cos table and the BatchNorm counters keep
    the values the model was built with."""
    model = (AViNetFusion(input_hw=tuple(input_hw)) if fusion else
             AViNet(use_transformer=use_transformer, input_hw=tuple(input_hw)))
    sd = {f"visual_model.{k}": v for k, v in load_artifact(path).state_dict().items()}
    sd.update(seeded_av_leaves(model, seed))
    sd.update({k: v for k, v in model.state_dict().items()
               if k not in sd and k.endswith((".pe", "num_batches_tracked"))})
    model.load_state_dict(sd, strict=True)
    return model.float()
