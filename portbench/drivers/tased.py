"""Closed-loop TASEDv2 parity inference over stored videos: the parity
driver's loop (``drivers/parity.py``: its videos, window, sample and check)
on the predictor that ``cli/generate_result.py::make_predictor`` builds for
``--model tased``, through ``emit_maps``. The reference is
``reference/tased.py::RefTASED``.

Weights (the configuration's ``assumed``): the S3D stages from the fixture,
the decoder drawn on the device from the seed, its BatchNorm running
statistics those of one train-mode pass of the reference (momentum 1) over
``statistics_clips`` seeded clips. They reach the program as the CLI's
``--file_weight``, a state_dict written to a temporary file during set-up.

The predictor replays TASEDv2's forward as a CUDA graph (``--cuda_graph``):
at window batch 8 the host's launches of the forward, op by op, take about
two thirds of the device's time for it, and their jitter reached the window's
rate. The videos are held in page-locked host memory, as a decoder that
writes into pinned buffers leaves them, so a video's upload is one DMA and
not a copy by the host's CPU through staging buffers.

Traffic parameters: those of ``drivers/parity.py``.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from portbench import frames
# window, traced_work and release are this driver's as they are the parity driver's
from portbench.drivers.parity import (  # noqa: F401
    _videos, check_sampled, compare, emit, release, sample, traced_work, window, window_clip)
from portbench.reference.post import normalise, post
from portbench.reference.tased import RefTASED
from portbench.reference.weights import fixture_state_dict

STATISTICS_INDEX = 1 << 20  # frames.video index of the statistics clips, apart from the traffic's


class State:
    pass


def _decoder_leaves(model: RefTASED, names: list, seed: int, device) -> dict:
    """Values for the decoder's leaves, drawn on device from seed in one
    generator, in the order of the sorted names: conv and transposed-conv
    weights N(0, 1/fan_in), fan_in = C_in x kernel volume; the last conv's
    bias N(0, 0.01²); BatchNorm weight 1 + N(0, 0.1²), bias N(0, 0.1²);
    running mean 0 and var 1 (the statistics pass replaces them);
    ``num_batches_tracked`` 0."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    out = {}
    for name in sorted(names):
        holder, leaf = name.rsplit(".", 1)
        m = model.get_submodule(holder)
        if leaf == "num_batches_tracked":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif leaf in ("running_mean", "running_var"):
            out[name] = torch.full(shapes[name], float(leaf == "running_var"), device=device)
        else:
            v = torch.randn(shapes[name], generator=g, device=device)
            if isinstance(m, torch.nn.BatchNorm3d):
                v = 1.0 + 0.1 * v if leaf == "weight" else 0.1 * v
            elif leaf == "bias":
                v = 0.01 * v
            else:
                v = v / float(np.sqrt(m.in_channels * np.prod(m.kernel_size)))
            out[name] = v
    return out


def weights(cell) -> dict:
    """The configuration's TASEDv2 state_dict (float32, CPU tensors)."""
    cfg, dev = cell.config, cell.device
    model = RefTASED().to(dev).eval()
    s3d = {k[len("backbone."):]: v for k, v in
           fixture_state_dict(cfg["weights"], cfg["weights_sha256"]).items()
           if k.startswith("backbone.")}
    decoder = [k for k in model.state_dict() if k not in s3d]
    model.load_state_dict({**s3d, **_decoder_leaves(model, decoder, cell.seed, dev)},
                          strict=True)
    clips = torch.stack([normalise(frames.video(cell.seed, STATISTICS_INDEX + i, cfg["clip_size"],
                                                cfg["input_h"], cfg["input_w"], dev))
                         for i in range(cfg["statistics_clips"])])
    for stage in model.stages():
        for bn in stage:
            if isinstance(bn, torch.nn.BatchNorm3d):
                bn.train()
                bn.momentum = 1.0
    with torch.no_grad():
        model(clips)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def cli_args(cfg: dict, traffic: dict, device: str, file_weight: str):
    """The parity CLI's flags for TASEDv2, parsed by its parser."""
    from vinet_tpu_torch.cli.generate_result import build_parser

    return build_parser().parse_args([
        "--path_indata", "-", "--save_path", "-", "--model", cfg["model"],
        "--file_weight", file_weight, "--window_batch", str(traffic["window_batch"]),
        "--cuda_graph",
        "--dtype", cfg["dtype"], "--clip_size", str(cfg["clip_size"]),
        "--input_h", str(cfg["input_h"]), "--input_w", str(cfg["input_w"]), "--device", device])


def setup(cell) -> State:
    from vinet_tpu_torch.cli.generate_result import make_predictor

    cfg = cell.config
    st = State()
    st.weights = weights(cell)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tased.pt")
        torch.save(st.weights, path)
        st.args = cli_args(cfg, cell.traffic, cell.device, path)
        st.predictor = make_predictor(st.args)
    st.out_hw = (cfg["frame_h"], cfg["frame_w"])
    st.videos, st.kept = _videos(cell)
    if cell.device != "cpu":
        st.pinned = [torch.from_numpy(v).pin_memory() for v in st.videos]
        st.videos = [t.numpy() for t in st.pinned]
    # every shape of the window, as the parity driver warms them
    warm = st.videos[0][: 2 * cfg["clip_size"] + 3 * cell.traffic["window_batch"]]
    for _ in range(2):
        for _ in emit(st, warm):
            pass
    if cell.device != "cpu":
        torch.cuda.synchronize()
    return st


def reference_maps(st: State, cell, keys: list, quant: bool = False, raw: dict | None = None):
    """The reference's uint8 maps at keys; with raw, also its float maps
    before the post ops there."""
    cfg = cell.config
    model = RefTASED()
    model.load_state_dict(st.weights, strict=True)
    model = model.eval().to(cell.device)
    model.quant.on = quant
    out = {}
    with torch.no_grad():
        for lo in range(0, len(keys), 4):
            ks = keys[lo: lo + 4]
            x = torch.stack([normalise(torch.from_numpy(np.ascontiguousarray(
                window_clip(st.videos[v], f, cfg["clip_size"]))).to(cell.device))
                for v, f in ks])
            y = model(x)
            if raw is not None:
                raw.update(zip(ks, y.cpu().numpy()))
            out.update(zip(ks, post(y, (cfg["frame_h"], cfg["frame_w"])).cpu().numpy()))
    return out


def check(st: State, cell, limits: dict) -> tuple:
    return check_sampled(st.maps, sample(st, cell),
                         lambda keys: reference_maps(st, cell, keys), limits)


def control(cell, seeds: list, n_videos: int) -> list:
    """Readings of the program (the window's own path) and of the control,
    the int8-rounded reference (TASEDv2 has no int8 path), each against the
    reference, on the kept maps of each seed's first n_videos videos; with
    the spread of the reference's maps (float before the post ops: min, max,
    standard deviation; uint8: standard deviation, shares at 0 and 255)."""
    inf = {"map_mean_abs_u8": float("inf"), "map_max_abs_u8": float("inf")}
    rows = []
    for seed in seeds:
        cell.seed = seed
        st = setup(cell)
        st.videos_done = n_videos
        keys = sample(st, cell)
        prog = {}
        for v in sorted({v for v, _ in keys}):
            for f, m in emit(st, st.videos[v]):
                if (v, f) in keys:
                    prog[(v, f)] = np.array(m)
        st.predictor = None
        raw = {}
        ref = reference_maps(st, cell, keys, raw=raw)
        ref_q = reference_maps(st, cell, keys, quant=True)
        r, u = np.stack(list(raw.values())), np.stack(list(ref.values()))
        rows.append({"seed": seed, "maps": len(keys),
                     "program": {k: v["value"] for k, v in compare(prog, ref, inf).items()},
                     "reference_int8": {k: v["value"]
                                        for k, v in compare(ref_q, ref, inf).items()},
                     "reference_float": {"min": float(r.min()), "max": float(r.max()),
                                         "std": float(r.std())},
                     "reference_u8": {"std": float(u.std()), "at_0": float((u == 0).mean()),
                                      "at_255": float((u == 255).mean())}})
    return rows
