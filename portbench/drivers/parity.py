"""Closed-loop parity inference over stored videos: the CLI's own
``cli/generate_result.py::emit_maps`` on a ``make_predictor`` predictor
(sliding windows, BatchNorm folded), one video after another, as
``generate_result`` walks a directory, without its JPEG decode and PNG
encode (the frames are decoded, model-sized, in host memory).

Traffic parameters (``traffic/<name>.json``): ``lengths``, the video
lengths in frames, held in that order rotated by the seed and cycled;
``window_batch``; ``kept_per_video``, maps of each video kept for the
check (one from the flipped warm-up windows, the last, the rest drawn);
``sample_maps``, how many of the kept maps the reference recomputes.

The window runs videos until ``seconds`` have passed and ends with the
video in progress: ``maps_per_s`` is every map delivered to the host over
all the window's time.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from portbench import frames
from portbench.reference.models import RefViNet
from portbench.reference.post import normalise, post
from portbench.reference.weights import fixture_state_dict


def cli_args(cfg: dict, traffic: dict, device: str) -> argparse.Namespace:
    """The parity CLI's flags for the configuration, parsed by its parser."""
    from vinet_tpu_torch.cli.generate_result import build_parser

    return build_parser().parse_args([
        "--path_indata", "-", "--save_path", "-", "--file_weight", cfg["weights"],
        "--window_batch", str(traffic["window_batch"]), "--dtype", cfg["dtype"],
        "--clip_size", str(cfg["clip_size"]), "--num_hier", str(cfg["num_hier"]),
        "--input_h", str(cfg["input_h"]), "--input_w", str(cfg["input_w"]),
        "--device", device])


class State:
    pass


def _videos(cell) -> tuple:
    """(host uint8 videos in window order, kept frame sets) from the seed."""
    cfg, tr = cell.config, cell.traffic
    lengths = list(tr["lengths"])
    rot = cell.seed % len(lengths)
    lengths = lengths[rot:] + lengths[:rot]
    rng = frames.rng(cell.seed, 7)
    vids, kept = [], []
    for i, n in enumerate(lengths):
        v = frames.video(cell.seed, i, n, cfg["input_h"], cfg["input_w"], cell.device)
        vids.append(v.cpu().numpy())
        extra = rng.choice(np.arange(cfg["clip_size"], n - 1), tr["kept_per_video"] - 2,
                           replace=False)
        kept.append({int(rng.integers(0, cfg["clip_size"] - 1)), n - 1, *map(int, extra)})
    return vids, kept


def setup(cell) -> State:
    from vinet_tpu_torch.cli.generate_result import make_predictor

    cfg = cell.config
    fixture_state_dict(cfg["weights"], cfg["weights_sha256"])  # the file is the one named
    st = State()
    st.args = cli_args(cfg, cell.traffic, cell.device)
    st.predictor = make_predictor(st.args)
    st.out_hw = (cfg["frame_h"], cfg["frame_w"])
    st.videos, st.kept = _videos(cell)
    # every shape of the window: full and padded batches, a fetch of
    # FETCH_EVERY batches and a shorter last one, the first video's upload
    warm = st.videos[0][: 2 * cfg["clip_size"] + 3 * cell.traffic["window_batch"]]
    for _ in range(2):
        for _ in emit(st, warm):
            pass
    _sync(cell)
    return st


def _sync(cell):
    if cell.device != "cpu":
        torch.cuda.synchronize()


def emit(st, clip_u8):
    from vinet_tpu_torch.cli.generate_result import emit_maps

    return emit_maps(st.predictor, st.args, clip_u8, st.out_hw)


def window(st: State, cell) -> dict:
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    st.maps, st.expected, st.got = {}, 0, 0
    i = 0
    while True:
        v = i % len(st.videos)
        clip = st.videos[v]
        st.expected += clip.shape[0]
        for f, smap in emit(st, clip):
            st.got += 1
            if i < len(st.videos) and f in st.kept[v]:
                st.maps[(v, f)] = np.array(smap)
        i += 1
        if time.perf_counter() >= deadline:
            break
    elapsed = time.perf_counter() - t0
    st.videos_done = i
    return {"maps_per_s": st.got / elapsed, "window_s": elapsed, "maps": st.got,
            "attempted": st.expected, "failed": st.expected - st.got}


def traced_work(st: State, cell):
    """A steady stretch for the profiler: the first video's first 256 maps."""
    clip = st.videos[0][:256]
    return lambda: [None for _ in emit(st, clip)]


def release(st: State) -> None:
    st.predictor = None


def sample(st: State, cell) -> list:
    """(video, frame) of the maps the reference recomputes: drawn from the
    seed among the kept maps of the videos the window completed."""
    keys = sorted((v, f) for v in range(min(st.videos_done, len(st.videos)))
                  for f in st.kept[v])
    rng = frames.rng(cell.seed, 11)
    n = min(cell.traffic["sample_maps"], len(keys))
    return [keys[j] for j in sorted(rng.choice(len(keys), n, replace=False))]


def window_clip(clip_u8: np.ndarray, f: int, t: int) -> np.ndarray:
    """The frames of frame f's window in the published order: the causal
    window ending at f, or for f < t - 1 the time-flipped window starting
    at f."""
    if f >= t - 1:
        return clip_u8[f - t + 1: f + 1]
    return clip_u8[f: f + t][::-1]


def reference_maps(st: State, cell, keys: list, quant: bool = False) -> dict:
    cfg = cell.config
    model = RefViNet()
    model.load_state_dict(fixture_state_dict(cfg["weights"]), strict=True)
    model = model.eval().to(cell.device)
    model.quant.on = quant
    out = {}
    with torch.no_grad():
        for lo in range(0, len(keys), 4):
            ks = keys[lo: lo + 4]
            x = torch.stack([normalise(torch.from_numpy(np.ascontiguousarray(
                window_clip(st.videos[v], f, cfg["clip_size"]))).to(cell.device))
                for v, f in ks])
            maps = post(model(x), (cfg["frame_h"], cfg["frame_w"])).cpu().numpy()
            out.update(zip(ks, maps))
    return out


def compare(program: dict, reference: dict, limits: dict) -> dict:
    """The numbers compared, each with its limit: the mean and the largest
    absolute gap in grey levels over every pixel of the sampled maps."""
    d = np.stack([np.abs(program[k].astype(np.int32) - reference[k].astype(np.int32))
                  for k in reference])
    return {"map_mean_abs_u8": {"value": float(d.mean()), "limit": limits["map_mean_abs_u8"]},
            "map_max_abs_u8": {"value": float(d.max()), "limit": limits["map_max_abs_u8"]}}


def check_sampled(maps: dict, keys: list, reference, limits: dict) -> tuple:
    """(correct, compared) of the program's maps at keys against
    reference(keys present); a sampled map that never came fails."""
    missing = [k for k in keys if k not in maps]
    ref = reference([k for k in keys if k in maps])
    compared = compare(maps, ref, limits) if ref else {}
    ok = not missing and bool(ref) and all(c["value"] <= c["limit"] for c in compared.values())
    return ok, {**compared, "sampled_maps_missing": {"value": len(missing), "limit": 0}}


def check(st: State, cell, limits: dict) -> tuple:
    return check_sampled(st.maps, sample(st, cell),
                         lambda keys: reference_maps(st, cell, keys), limits)


def control(cell, seeds: list, n_videos: int) -> list:
    """Readings of the program (the window's own path) and of the control,
    the program's int8 path (``make_inference_fn(..., dtype="int8")``,
    calibrated on the first and the last window of the first seed's first video), each
    against the reference, on the kept maps of each seed's first n_videos
    videos; also the reference's own int8 rounding (``quant=True``)."""
    from vinet_tpu_torch.cli.common import build_model
    from vinet_tpu_torch.data.pipeline import device_preprocess
    from vinet_tpu_torch.inference import SlidingWindowPredictor
    from vinet_tpu_torch.models.inference import make_inference_fn

    cell.seed = seeds[0]
    st = setup(cell)
    t = cell.config["clip_size"]
    calib = device_preprocess(torch.from_numpy(np.stack(
        [st.videos[0][:t], st.videos[0][-t:]])).to(cell.device))
    _, m8 = make_inference_fn(build_model(st.args), dtype="int8", calib_clips=calib,
                              device=cell.device)
    p8 = SlidingWindowPredictor(m8, clip_size=t, batch=cell.traffic["window_batch"],
                                dtype=torch.bfloat16, device=cell.device)
    limits = {"map_mean_abs_u8": float("inf"), "map_max_abs_u8": float("inf")}
    rows = []
    for seed in seeds:
        cell.seed = seed
        st.videos, st.kept = _videos(cell)
        st.videos_done = n_videos
        keys = sample(st, cell)
        need = sorted({v for v, _ in keys})
        prog, int8 = {}, {}
        for v in need:
            for f, m in emit(st, st.videos[v]):
                if (v, f) in keys:
                    prog[(v, f)] = np.array(m)
            for f, m in p8.predict_video(st.videos[v], out_size=st.out_hw, quantize_u8=True):
                if (v, f) in keys:
                    int8[(v, f)] = np.array(m)
        ref = reference_maps(st, cell, keys)
        ref_q = reference_maps(st, cell, keys, quant=True)
        rows.append({"seed": seed, "maps": len(keys),
                     "program": {k: v["value"] for k, v in compare(prog, ref, limits).items()},
                     "control_int8_program": {k: v["value"]
                                              for k, v in compare(int8, ref, limits).items()},
                     "reference_int8": {k: v["value"]
                                        for k, v in compare(ref_q, ref, limits).items()}})
    return rows
