#!/usr/bin/env python3
"""Drive vinet_tpu_torch's main path on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one card
and exits non-zero, printing no result, when CUDA is unavailable or any phase
fails. Phases, each printing one JSON line:

1. card: name and power limit from nvidia-smi;
2. build: every hand-written kernel of the main path, from the sources in the
   checkout (``vinet_tpu_torch/csrc``);
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shape and at other shapes, and its time beside its plain
   version's, the library yardstick's and the card's bound;
4. model: the full-width ViNet(3, 32) with the committed fixture weights
   (``artifacts/streamft_fixture.npz``), BatchNorm folded, on a window batch
   of 16 clips of 32 x 224 x 384 in bf16, against f32 on the card, and f32 on
   the card against the CPU at a reduced input, its bf16 clips/s, and a
   profile of one bf16 window batch (FLOP count, device time by kernel);
5. cli (the main path): ``vinet_tpu_torch.cli.generate_result`` end to end on
   a synthetic DHF1K-layout directory; the kernels' launch counts are set to 0
   just before and read just after.

Then one line lists every kernel with its numbers, and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

FIXTURE = os.path.join("artifacts", "streamft_fixture.npz")
# H100 SXM data sheet: HBM rate, and dense peaks by input type (f32 on the
# CUDA cores; bf16 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
KERNEL_TOL = 1e-5  # kernel vs plain: same inputs, both accumulate in f32
CPU_TOL = 2e-3  # card f32 vs CPU f32: the port's parity anchor against JAX
# bf16 vs f32 on the card: bf16 keeps 8 significant bits (relative rounding
# 2^-9) through some 60 convolutions, whose errors add up to about 1e-2 of a
# logit; the sigmoid's slope is at most 1/4
BF16_MAX_TOL, BF16_MEAN_TOL = 5e-2, 5e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn over iters launches, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi})
    return smi


def phase_build() -> None:
    from vinet_tpu_torch.ops import build

    t0 = time.perf_counter()
    so = build.build("saliency_head")
    log = so.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines() if "Used" in ln] \
        if log.exists() else []
    emit({"phase": "build", "kernels": ["saliency_head"], "seconds": time.perf_counter() - t0,
          "library": str(so.relative_to(os.getcwd())), "ptxas": ptxas})


def _head_inputs(torch, b, kt, h, w, bias, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    z = torch.relu(torch.randn((b, 32, kt, h, w), generator=g, device=dev)).to(dtype)
    w6 = torch.randn((32, 32, kt, 1, 1), generator=g, device=dev) * 0.1
    b6 = torch.randn((32,), generator=g, device=dev) * 0.1 if bias else None
    w7 = torch.randn((1, 32, 1, 1, 1), generator=g, device=dev) * 0.3
    b7 = torch.randn((1,), generator=g, device=dev) * 0.1
    return z, w6, b6, w7, b7


def phase_kernels(torch) -> dict:
    """The head kernel against its plain version; times at the main shape."""
    import torch.nn.functional as F

    from vinet_tpu_torch.ops import saliency_head as head

    cases = [  # (name, B, kt, H, W, b6, dtype); the first is the main path's
        ("clip32_main_bf16", 16, 2, 224, 384, False, torch.bfloat16),
        ("clip32_main_f32", 16, 2, 224, 384, False, torch.float32),
        ("clip48_kt3_bias_bf16", 4, 3, 224, 384, True, torch.bfloat16),
        ("ragged_37x53_bias_f32", 3, 2, 37, 53, True, torch.float32),
        ("ragged_13x7_bf16", 2, 2, 13, 7, False, torch.bfloat16),
    ]
    main = None
    for i, (name, b, kt, h, w, bias, dtype) in enumerate(cases):
        args = _head_inputs(torch, b, kt, h, w, bias, dtype, seed=i)
        got = head.saliency_head_cuda(*args)
        want = head.saliency_head_plain(*args)
        torch.cuda.synchronize()
        check(got.shape == (b, h, w) and bool(torch.isfinite(got).all()), f"{name}: output")
        err = float((got - want).abs().max())
        rec = {"phase": "kernel_check", "kernel": "saliency_head", "case": name,
               "shape": [b, 32, kt, h, w], "dtype": str(dtype), "b6": bias,
               "max_abs_err": err, "tol": KERNEL_TOL}
        emit(rec)
        check(err <= KERNEL_TOL, f"saliency_head {name}: max|err| {err} > {KERNEL_TOL}")
        if i == 0:
            main = (args, err)

    (z, w6, b6, w7, b7), err = main
    b, _, kt, h, w = z.shape
    iters = 50
    kernel_ms = cuda_ms(torch, lambda: head.saliency_head_cuda(z, w6, b6, w7, b7), iters)
    plain_ms = cuda_ms(torch, lambda: head.saliency_head_plain(z, w6, b6, w7, b7), iters)
    w6l, w7l = w6.to(z.dtype), w7.to(z.dtype)
    b7l = b7.to(z.dtype)

    def library():  # unfused conv3d -> relu -> conv3d -> sigmoid (cuDNN)
        y = torch.relu(F.conv3d(z, w6l))
        return torch.sigmoid(F.conv3d(y, w7l, b7l))[:, 0, 0]

    library_ms = cuda_ms(torch, library, iters)
    n_pix = b * h * w
    bytes_moved = z.numel() * z.element_size() + n_pix * 4 + 4 * (w6.numel() + w7.numel() + 1)
    ops = n_pix * (2 * 32 * 32 * kt + 2 * 32)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[str(z.dtype)] * 1e3
    rec = {"name": "saliency_head", "route": "cuda",
           "source": "vinet_tpu_torch/csrc/saliency_head.cu",
           "replaces": "vinet_tpu/ops/pallas_head.py:54",
           "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    emit({"phase": "kernel_time", "kernel": "saliency_head", "shape": list(z.shape),
          "dtype": str(z.dtype), "bytes": bytes_moved, "flop": ops,
          "bytes_ms": bytes_ms, "ops_ms": ops_ms, "kernel_ms": kernel_ms,
          "bound_us": rec["bound_ms"] * 1e3,
          "f32_cuda_core_ms": ops / PEAK_OPS_PER_S["torch.float32"] * 1e3,
          **{k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
    return rec


def profile_window_batch(torch, model, x) -> dict:
    """The model's FLOP count (PyTorch's operators; the head kernel's 4,160
    FLOP a pixel are not in it) and where the device time of one window batch
    goes, by kernel, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as flops:
        model(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    return {"flop_per_clip": flops.get_total_flops() / x.shape[0],
            "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "head_ms": sum(ms for k, ms, _ in kernels if "saliency_head" in k),
            "top_kernels": [[k[:80], ms, n] for k, ms, n in kernels[:10]]}


def phase_model(torch) -> None:
    from vinet_tpu_torch.data.pipeline import device_preprocess
    from vinet_tpu_torch.io.weights import load_weights
    from vinet_tpu_torch.models import ViNet, cast_floating, fold_batchnorms
    from vinet_tpu_torch.ops import saliency_head as head

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = ViNet(3, 32)
    model.load_state_dict(load_weights(FIXTURE), strict=True)
    model = fold_batchnorms(model.eval())
    cpu32 = cast_floating(copy.deepcopy(model), torch.float32)
    gpu32 = copy.deepcopy(cpu32).cuda()
    gpu16 = cast_floating(copy.deepcopy(model), torch.bfloat16).cuda()

    g = torch.Generator(device="cuda").manual_seed(0)
    u8 = torch.randint(0, 256, (16, 32, 224, 384, 3), generator=g, device="cuda",
                       dtype=torch.uint8)
    x = device_preprocess(u8)
    launches0 = head.launches
    with torch.inference_mode():
        out16 = gpu16(x.to(torch.bfloat16)).float()
        out32 = gpu32(x)
        torch.cuda.synchronize()
        check(out16.shape == (16, 224, 384) and bool(torch.isfinite(out16).all()),
              "bf16 model output")
        d = (out16 - out32).abs()
        bf16_max, bf16_mean = float(d.max()), float(d.mean())

        # reduced input for the CPU: H and W stay multiples of 32, or the
        # decoder's skip concatenations do not line up
        small = device_preprocess(torch.randint(0, 256, (1, 32, 128, 192, 3), generator=g,
                                                device="cuda", dtype=torch.uint8))
        on_card = gpu32(small).cpu()
        on_cpu = cpu32(small.cpu())
        cpu_err = float((on_card - on_cpu).abs().max())

        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            gpu16(x.to(torch.bfloat16))
        torch.cuda.synchronize()
        clips_per_s = iters * x.shape[0] / (time.perf_counter() - t0)
        profile = profile_window_batch(torch, gpu16, x.to(torch.bfloat16))
    emit({"phase": "profile", "input": list(x.shape), "dtype": "torch.bfloat16",
          "achieved_tflop_per_s": profile["flop_per_clip"] * clips_per_s / 1e12, **profile})
    emit({"phase": "model", "config": "ViNet(3,32) fixture weights, BN folded",
          "input": list(x.shape), "bf16_vs_f32_max_abs_err": bf16_max,
          "bf16_vs_f32_mean_abs_err": bf16_mean, "bf16_tol": [BF16_MAX_TOL, BF16_MEAN_TOL],
          "card_f32_vs_cpu_f32_max_abs_err": cpu_err, "cpu_input": [1, 32, 128, 192, 3],
          "cpu_tol": CPU_TOL, "bf16_clips_per_s": clips_per_s,
          "head_launches": head.launches - launches0,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(bf16_max <= BF16_MAX_TOL and bf16_mean <= BF16_MEAN_TOL,
          f"bf16 vs f32: max {bf16_max}, mean {bf16_mean}")
    check(cpu_err < CPU_TOL, f"card f32 vs CPU f32: max|err| {cpu_err}")
    check(head.launches > launches0, "the model's head did not launch the kernel")


def _write_videos(root: str, n_videos: int, n_frames: int, size: tuple) -> None:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    for v in range(n_videos):
        d = os.path.join(root, "%03d" % (v + 1), "images")
        os.makedirs(d)
        for f in range(n_frames):
            cy, cx = h / 2, w * (0.2 + 0.6 * f / n_frames)
            blob = 175.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 40.0**2))
            img = rng.integers(0, 80, (h, w, 3)) + blob[..., None]
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(d, "%04d.png" % (f + 1)))


def phase_cli(torch) -> dict:
    """The main path: the port's generate_result CLI on the card."""
    import numpy as np
    from PIL import Image

    from vinet_tpu_torch.cli.generate_result import main as generate_main
    from vinet_tpu_torch.ops import saliency_head as head

    n_videos, n_frames, size = 2, 80, (360, 640)
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        _write_videos(data, n_videos, n_frames, size)
        torch.cuda.synchronize()
        head.launches = 0
        t0 = time.perf_counter()
        rc = generate_main(["--path_indata", data, "--save_path", out,
                            "--file_weight", FIXTURE, "--device", "cuda"])
        seconds = time.perf_counter() - t0
        launches = {"saliency_head": head.launches}
        check(rc == 0, f"generate_result returned {rc}")
        for v in range(n_videos):
            name = "%03d" % (v + 1)
            frames = sorted(os.listdir(os.path.join(data, name, "images")))
            written = sorted(os.listdir(os.path.join(out, name)))
            check(written == frames, f"video {name}: {len(written)} maps for {len(frames)} frames")
            m = np.asarray(Image.open(os.path.join(out, name, written[-1])))
            check(m.shape == size and m.dtype == np.uint8 and m.min() == 0 and m.max() == 255,
                  f"video {name}: map {m.shape} {m.dtype} [{m.min()}, {m.max()}]")
    n_maps = n_videos * n_frames  # one window per map, flipped for the first 31
    emit({"phase": "cli", "videos": n_videos, "frames": n_frames, "frame_size": list(size),
          "maps": n_maps, "window_batches": n_videos * -(-n_frames // 16),
          "seconds": seconds, "maps_per_s": n_maps / seconds, "launches": launches})
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    import vinet_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t0 = time.perf_counter()
    phase_card()
    phase_build()
    kernel = phase_kernels(torch)
    phase_model(torch)
    launches = phase_cli(torch)
    kernel["launches"] = launches[kernel["name"]]
    emit({"kernels": [kernel]})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
