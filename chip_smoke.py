#!/usr/bin/env python3
"""Drive vinet_tpu_torch's main path on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one card
and exits non-zero, printing no result, when CUDA is unavailable or any phase
fails. Phases, each printing one JSON line:

1. card: name and power limit from nvidia-smi;
2. build: every hand-written kernel, from the sources in the checkout
   (``vinet_tpu_torch/csrc``), one ``nvcc`` per source, all at once; the
   ``ptxas`` report (no spills allowed) and, from ``cuobjdump -sass``, each
   library's count of tensor-core (``IMMA``, ``HMMA``) and ``cp.async``
   (``LDGSTS``) instructions: ``int8_mm`` and ``tconv`` must have all three,
   every bf16 instance of the head ``HMMA`` and every cp.async instance of
   it ``LDGSTS``;
3. kernel_check / kernel_time: each kernel against its plain PyTorch version
   on the card at its paths' shapes, the model's widths and ragged shapes,
   with B both K-major and row-major (int8 exactly, bf16 and f32 within
   1e-5), and its time beside its plain version's, the library call's (for
   int8_mm the faster of B as the kernel gets it and a row-major copy) and
   the card's bound; at 4096 x 1024 x 1024 also with the host's cost per
   call left in. The head in both modes: fused with the last 2x upsample on
   the coarse z5 (the main path's) and at full resolution; beside them the
   time of that upsample alone;
4. model: the full-width ViNet(3, 32) with the committed fixture weights
   (``artifacts/streamft_fixture.npz``), BatchNorm folded, on a window batch
   of 16 clips of 32 x 224 x 384 in bf16, against f32 on the card, and f32 on
   the card against the CPU at a reduced input, its bf16 clips/s, and a
   profile of one bf16 window batch (FLOP count, device time by kernel,
   the head's time, which must not be 0, and the upsample launches: 4, the
   fifth is fused into the head);
5. int8_model (the int8 path): the same model and window batch through
   ``make_inference_fn(dtype="int8")``, calibrated on the batch's first 2
   clips in f32; its clips/s and peak memory, int8 against bf16 on the card,
   and int8 on the card against int8 on the CPU (the same scales) at a
   reduced input. Launch counts are set to 0 just before one forward and read
   just after;
6. cli (the bf16 main path): ``vinet_tpu_torch.cli.generate_result`` end to
   end on a synthetic DHF1K-layout directory; the launch counts are set to 0
   just before and read just after;
7. phasefold: conv after a 2x upsample both ways, folded
   (``ops/phasefold.py``) and upsample then conv, at the decoder's conv5
   and the streaming decode's conv3/conv4 taps (window batch 16, 224 x
   384): f32 check, bf16 times with cuDNN's heuristics and its benchmark
   mode; the decoder's tail once;
8. streaming: ``generate_result --streaming`` on synthetic 160-frame videos
   at 224 x 384, its maps/s; the device time of one 128-frame chunk by part
   (timeline, dense front, window decode) and by kernel; card bf16 against
   card f32 maps, and card f32 against CPU f32 at a reduced size;
9. live: ``LiveStreamingPredictor`` at micro 16 over one stream: ms a feed,
   maps/s and lag in frames, bf16; in f32 its interior maps against the
   card's chunked maps;
10. serve: ``vinet_tpu_torch.cli.serve --streams 4 --live_micro 32``, its
   maps/s, and the device time of one serve step (an advance of 4 streams
   and one decode of 4 x 32 windows).

11. train: the full-width ViNet(3, 32) with the fixture weights, BatchNorm
   unfolded in train mode, bf16 convolutions over f32 masters, Adam 1e-4,
   batch 8 at 32 x 224 x 384: 2 warm-up and 5 timed steps (ms, clips/s,
   peak memory, the loss of each, which must fall; every gradient finite;
   every BatchNorm statistic moved; no head launch), a profile of one step,
   the eval step (the fused head must launch), the CUDA entries' refusal of
   autograd, one f32 step of ViNet(3, 8) on the card against the CPU, and
   grad_accum 2 against the mean of its microbatches; then
   ``vinet_tpu_torch.cli.train`` with validation and a checkpoint, again with
   --resume (the step count goes on), and --streaming_ft (BatchNorm
   statistics unchanged).

12. accuracy: with ``artifacts/streamft_fixture.npz`` at 224 x 384,
   ``inference/accuracy.py``'s fixture suite (5 kinds x 72 frames, bf16) and
   blob video (bf16 and f32), held to the JAX tests' bounds
   (tests/test_streaming_ft_artifact.py); ``generate_result`` then
   ``evaluate_dhf1k`` with all nine metrics on a synthetic DHF1K-layout set;
   ``diem_val`` against ``eval_diem --emd`` on its STAViS layout (per-frame
   CC within 0.01); ``export_checkpoint`` from the fixture and from the train
   phase's checkpoint (maps reproduced exactly, mismatched flags refused);
   the metrics' host ms per frame and the CLIs' frames/s.

13. av: AViNet(3, 32) at 224 x 384, the visual model from the fixture, the
   audio and fusion weights from a numpy seed
   (``inference/accuracy.py::av_fixture_model``), BatchNorm folded: a window
   batch of 16 clips with (16, 70560, 1) audio in bf16 (clips/s, device time
   by part: backbone, SoundNet + pool + bilinear, decoder), against f32, f32
   card against CPU on one clip, the refinement encoder once at batch 2;
   ``generate_result_audio_visual`` (parity, ``--streaming``, ``--live
   --live_micro 16``), ``generate_result_dave --fps_json`` and
   ``generate_theatre`` (a 44.1 kHz wav) on 2 synthetic videos x 72 frames
   with their wavs (maps/s, a JPEG map for every frame); one 128-frame
   ``--streaming`` chunk's device time by part; ``AVMultiLiveServer`` at 4
   streams x micro 32 against single-stream live in f32, its bf16 maps/s
   and one serve step's device time; ``evaluate_av_agreement`` on the
   fixture suite in bf16, the blob kind within 0.005 of f32.

14. av_train: AViNet(3, 32) at 224 x 384 (the fixture's visual weights,
   the rest seeded), BatchNorm unfolded, bf16 convolutions over f32
   masters, Adam 1e-4, batch 8 with (8, 70560, 1) audio: 2 warm-up and 5
   timed steps with the bilinear fusion and again with the refinement
   encoder (ms, peak memory, finite losses and gradients, every statistic
   moved, SoundNet's included, no kernel launched in a step), a profile of
   one bilinear step; the eval step
   through the fused head; dropout on the card (the encoder at lr 0: steps
   0 and 1 differ, step 0 repeats exactly, a state without a seed repeats);
   one f32 step at 2 x 32 x 64 x 96 on the card against the CPU (loss and
   statistics); AViNetFusion(512) bf16 against f32 through
   ``make_inference_fn`` with audio, and its train steps; then
   ``vinet_tpu_torch.cli.train --dataset SoundDataset --use_sound True
   --use_transformer True --bf16`` on the six STAViS sets (3 videos x 40
   frames each) with validation, a checkpoint and --resume with --bn_recal.

15. parallel: the parallel paths (``vinet_tpu_torch/parallel``) as one rank
   of a world of 1 over NCCL, in a child process started with the spawn
   method (the VINET_* bring-up of ``utils/runtime.py::init_distributed``),
   whose process group ends with it; ViNet(3, 32) with the fixture weights
   at 224 x 384: the parity predictor with ``mesh=`` (bf16, batch 16) on
   phase cli's first video equals the predictor without one;
   ``generate_result --data_parallel`` writes phase cli's PNGs byte for
   byte; the train step over a mesh whose data group is the world
   (``SyncBatchNorm`` for every BatchNorm and the gradient all-reduce, over
   NCCL) at batch 8: its f32 loss within 1e-5 of the unsharded step's, its
   bf16 step time and peak memory beside the unsharded step's, timed in
   turn in the same process (and phase train's); ``train
   --multihost`` (2 steps at batch 8, validation through the head, rank 0's
   checkpoint, --resume); ``serve --stream_parallel --streams 4`` writes
   phase serve's PNGs byte for byte; ``streaming_pyramid_tsharded`` on a
   128-frame chunk against ``streaming_pyramid`` in f32 on a seeded
   ViNet(3, 32), as the JAX test's random init (interior within rtol/atol
   1e-4, edges within 0.1), and on the fixture's weights (reported). Two ranks on one card are not tried
   (NCCL refuses a duplicate GPU): multi-rank exactness is the CPU tests'
   (``tests/test_torch_parallel*.py``, gloo).

16. tased: TASEDv2 (``models/tased.py``) at full width on (B, 32, 224, 384,
   3), B 1 and 8, in bf16 autocast over f32 weights (the fixture's S3D, the
   decoder seeded from numpy, its running statistics from one seeded
   batch): the maps' shape and range, bf16 against f32, card against CPU
   at 32 x 32, forward ms, clips/s and peak memory, a profile of one B 8
   forward and each ConvTranspose3d alone (its time by CUDA events and
   cuDNN's kernels beside its bound). TASEDv2 launches no kernel of the
   repo (its transposed convolutions are XLA convolutions in the JAX
   package, not Pallas kernels), and the phase requires every count to stay
   0. Phase 11's train CLI also writes its best model as the JAX package's
   ``.npz`` trees (``--model_val_path best.npz``), which ``load_weights``
   reads back equal to the checkpointed model.

Phases 6-16 set the launch counts to 0 before their path, read them after,
and fail unless the fused head launched (phases 11, 14 and 15: in the eval
steps and the CLI's validation, and never in a train step; phase 16: never).
Then one line lists every kernel with its numbers (the head's launches on
every path), and the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

FIXTURE = os.path.join("artifacts", "streamft_fixture.npz")
KERNELS = ("saliency_head", "int8_mm", "tconv")
# H100 SXM data sheet: HBM rate, and dense peaks by input type (f32 on the
# CUDA cores; bf16 and int8 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.float32": 67e12, "torch.bfloat16": 989e12, "torch.int8": 1979e12}
KERNEL_TOL = 1e-5  # kernel vs plain: same inputs, both accumulate in f32
# (relative to the largest output for the GEMM kernels; int8 must be exact)
CPU_TOL = 2e-3  # card f32 vs CPU f32: the port's parity anchor against JAX
# bf16 vs f32 on the card: bf16 keeps 8 significant bits (relative rounding
# 2^-9) through some 60 convolutions, whose errors add up to about 1e-2 of a
# logit; the sigmoid's slope is at most 1/4
BF16_MAX_TOL, BF16_MEAN_TOL = 5e-2, 5e-3
# int8 vs bf16 maps on the card: every conv input and weight is rounded to
# 1/127 of its range (about 2^-7, bf16 keeps 2^-9), so the maps move more
# than bf16's own; measured on an NVIDIA H100 80GB HBM3 at 700 W: max 0.057,
# mean 0.0056, CC >= 0.985
INT8_MAX_TOL, INT8_MEAN_TOL, INT8_CC_MIN = 0.1, 0.01, 0.97
# int8 on the card vs int8 on the CPU with the same scales: the int32 sums are
# exact on both, so only bf16 rounding of the unquantized ops differs, and now
# and then flips an int8 level; measured on the same card: max 0.0034, mean
# 2.3e-6
INT8_CPU_MAX_TOL, INT8_CPU_MEAN_TOL = 0.01, 1e-5
# upsample_trilinear3d launches in a window batch: conv1-3's; conv5 folds the
# fourth (ops/phasefold.py), the head the fifth
UPSAMPLE_LAUNCHES = 3
# folded conv vs upsample + conv in f32 on the card: the same f32 products
# summed in other orders (up to 17,280 a sum), relative to the largest output
FOLD_TOL = 1e-5
# live vs chunked interior maps in f32 on the card: the same convolutions over
# the same positions, at other batch and time extents (vinet_tpu's own bound)
LIVE_MAX_TOL, LIVE_MEDIAN_TOL = 1e-4, 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def phase_card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi})
    return smi


SASS_OPS = ("IMMA", "HMMA", "LDGSTS", "LDSM")  # int8 / bf16 mma, cp.async, ldmatrix


def sass_counts(build, so) -> dict:
    """{function: {op: count}} of the library's SASS, from cuobjdump."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            op = re.search(r"\b(" + "|".join(SASS_OPS) + r")\b", line)
            if op:
                counts[fn][op.group(1)] += 1
    return counts


def ptxas_report(log: str) -> dict:
    """{function: {"regs": n, "spill_bytes": n}} from the -Xptxas -v log."""
    report, fn = {}, None
    for line in log.splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            fn = head.group(1)
            report[fn] = {"regs": None, "spill_bytes": 0}
        elif fn is not None:
            regs = re.search(r"Used (\d+) registers", line)
            if regs:
                report[fn]["regs"] = int(regs.group(1))
            report[fn]["spill_bytes"] += sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
    return report


def phase_build() -> None:
    from vinet_tpu_torch.ops import build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc each
        libs = list(pool.map(build.build, KERNELS))
    seconds = time.perf_counter() - t0
    functions, sass = {}, {}
    for name, so in zip(KERNELS, libs):
        ptxas = ptxas_report(so.with_suffix(".log").read_text())
        ops = sass_counts(build, so)
        functions[name] = {fn: {**ptxas.get(fn, {}), **ops.get(fn, {})}
                           for fn in sorted(set(ptxas) | set(ops))}
        sass[name] = {op: sum(c[op] for c in ops.values()) for op in SASS_OPS}
        if name != "saliency_head":  # the tensor-core GEMM kernels
            for fn, c in ops.items():
                check(c["IMMA"] > 0 if "NS_4Int8E" in fn else c["HMMA"] > 0,  # element type
                      f"{name}: {fn} has no tensor-core instruction")
            check(all(sass[name][op] > 0 for op in ("IMMA", "HMMA", "LDGSTS")),
                  f"{name}: SASS counts {sass[name]}")
        else:  # saliency_head_kernel<T, kUp, kAsync>: T t (bf16 bits) or f
            for fn, c in ops.items():
                inst = re.search(r"saliency_head_kernelI([tf])Lb([01])ELb([01])E", fn)
                check(inst is not None, f"saliency_head: unexpected function {fn}")
                check(inst.group(1) == "f" or c["HMMA"] > 0, f"{fn} has no HMMA")
                check(inst.group(3) == "0" or c["LDGSTS"] > 0, f"{fn} has no LDGSTS")
    spills = {name: sum(f.get("spill_bytes", 0) for f in functions[name].values())
              for name in KERNELS}
    emit({"phase": "build", "kernels": list(KERNELS), "seconds": seconds,
          "libraries": [str(so.relative_to(os.getcwd())) for so in libs], "sass": sass,
          "spill_bytes": spills, "functions": functions})
    check(not any(spills.values()), f"ptxas reports spills: {spills}")


def bound(bytes_moved: int, ops: int, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of dtype."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[str(dtype)] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _head_inputs(torch, b, kt, h, w, bias, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    z = torch.relu(torch.randn((b, 32, kt, h, w), generator=g, device=dev)).to(dtype)
    w6 = torch.randn((32, 32, kt, 1, 1), generator=g, device=dev) * 0.1
    b6 = torch.randn((32,), generator=g, device=dev) * 0.1 if bias else None
    w7 = torch.randn((1, 32, 1, 1, 1), generator=g, device=dev) * 0.3
    b7 = torch.randn((1,), generator=g, device=dev) * 0.1
    return z, w6, b6, w7, b7


# mode -> cases (name, B, kt, H, W, b6, dtype) of z (full) or z5 (up2x); the
# first of each is the main path's shape, timed
HEAD_CASES = {
    "up2x": [
        ("clip32_main_bf16", 16, 2, 112, 192, False, "bfloat16"),
        ("clip32_main_f32", 16, 2, 112, 192, False, "float32"),
        ("clip48_kt3_bias_bf16", 4, 3, 112, 192, True, "bfloat16"),
        ("ragged_37x53_bias_f32", 3, 2, 37, 53, True, "float32"),
        ("ragged_13x7_bf16", 2, 2, 13, 7, False, "bfloat16"),
        ("ragged_9x41_bias_bf16", 2, 2, 9, 41, True, "bfloat16"),
        ("ragged_1x1_f32", 2, 2, 1, 1, False, "float32"),
    ],
    "full": [
        ("clip32_main_bf16", 16, 2, 224, 384, False, "bfloat16"),
        ("clip32_main_f32", 16, 2, 224, 384, False, "float32"),
        ("clip48_kt3_bias_bf16", 4, 3, 224, 384, True, "bfloat16"),
        ("ragged_37x53_bias_f32", 3, 2, 37, 53, True, "float32"),
        ("ragged_13x7_bf16", 2, 2, 13, 7, False, "bfloat16"),
    ],
}


def _time_head(torch, mode, cuda_fn, plain_fn, args, iters) -> dict:
    """The head kernel of one mode at args: its time, its plain version's,
    the unfused cuDNN chain's (interpolate for up2x, conv3d, relu, conv3d,
    sigmoid in z's dtype) and the card's bound."""
    import torch.nn.functional as F

    from vinet_tpu_torch.ops.upsample import upsample2x_hw
    from vinet_tpu_torch.tools.timing import cuda_ms

    z, w6, b6, w7, b7 = args
    w6l, w7l, b7l = w6.to(z.dtype), w7.to(z.dtype), b7.to(z.dtype)

    def library():
        y = upsample2x_hw(z) if mode == "up2x" else z
        y = torch.relu(F.conv3d(y, w6l))
        return torch.sigmoid(F.conv3d(y, w7l, b7l))[:, 0, 0]

    b, _, kt, h, w = z.shape
    n_in = b * h * w  # pixels of z: conv6 runs on these
    n_out = n_in * (4 if mode == "up2x" else 1)
    bytes_moved = z.numel() * z.element_size() + n_out * 4 + 4 * (w6.numel() + w7.numel() + 1)
    ops = n_in * 2 * 32 * 32 * kt + n_out * 2 * 32  # conv6, conv7
    bound_ms, bound_by = bound(bytes_moved, ops, z.dtype)
    return {"ms": cuda_ms(lambda: cuda_fn(*args), iters),
            "plain_ms": cuda_ms(lambda: plain_fn(*args), iters),
            "library_ms": cuda_ms(library, iters), "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": bytes_moved, "flop": ops}


def phase_head_kernel(torch) -> dict:
    """The head kernel in both modes against its plain versions; times at the
    main path's shapes, and the last upsample alone. Returns the kernels-line
    row: the fused mode's numbers (the main path's), both modes under
    ``modes``."""
    from vinet_tpu_torch.ops import saliency_head as head
    from vinet_tpu_torch.ops.upsample import upsample2x_hw
    from vinet_tpu_torch.tools.timing import cuda_ms

    fns = {"up2x": (head.saliency_head_up2x_cuda, head.saliency_head_up2x_plain),
           "full": (head.saliency_head_cuda, head.saliency_head_plain)}
    modes = {}
    for mode, cases in HEAD_CASES.items():
        cuda_fn, plain_fn = fns[mode]
        for i, (name, b, kt, h, w, bias, dtype) in enumerate(cases):
            args = _head_inputs(torch, b, kt, h, w, bias, getattr(torch, dtype), seed=i)
            got = cuda_fn(*args)
            want = plain_fn(*args)
            torch.cuda.synchronize()
            s = 2 if mode == "up2x" else 1
            check(got.shape == (b, s * h, s * w) and bool(torch.isfinite(got).all()),
                  f"{mode} {name}: output")
            err = float((got - want).abs().max())
            emit({"phase": "kernel_check", "kernel": "saliency_head", "mode": mode, "case": name,
                  "shape": [b, 32, kt, h, w], "dtype": dtype, "b6": bias,
                  "max_abs_err": err, "tol": KERNEL_TOL})
            check(err <= KERNEL_TOL, f"saliency_head {mode} {name}: max|err| {err} > {KERNEL_TOL}")
            if i == 0:
                main = args
                modes[mode] = {"max_abs_err": err}
            del got, want
        rec = _time_head(torch, mode, cuda_fn, plain_fn, main, 50)
        modes[mode].update(rec)
        emit({"phase": "kernel_time", "kernel": "saliency_head", "mode": mode,
              "shape": list(main[0].shape), "dtype": str(main[0].dtype), **rec})
        if mode == "up2x":  # the upsample the fused mode removes, alone
            z5 = main[0]
            z5_cl = z5.contiguous(memory_format=torch.channels_last_3d)
            up = {"ncdhw": cuda_ms(lambda: upsample2x_hw(z5), 50),
                  "channels_last": cuda_ms(lambda: upsample2x_hw(z5_cl), 50)}
            emit({"phase": "kernel_time", "kernel": "last_upsample_alone",
                  "shape": list(z5.shape), "dtype": str(z5.dtype), "ms": up})
            modes[mode]["last_upsample_alone_ms"] = up
        del main
        torch.cuda.empty_cache()
    fused = modes["up2x"]
    return {"name": "saliency_head", "route": "cuda",
            "source": "vinet_tpu_torch/csrc/saliency_head.cu",
            "replaces": "vinet_tpu/ops/pallas_head.py:54",
            **{k: fused[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
            "modes": {m: {k: modes[m][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms")} for m in modes}}


def _gemm_operands(torch, dtype, shapes, seed):
    """Seeded operands on the card: int8 in [-127, 127], bf16 standard normal."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.int8:
        return [torch.randint(-127, 128, s, generator=g, device="cuda", dtype=torch.int8)
                for s in shapes]
    return [torch.randn(s, generator=g, device="cuda").to(dtype) for s in shapes]


def _gemm_err(torch, got, want, dtype) -> float:
    """int8: max|err| (must be 0); bf16: max|err| over the largest output."""
    err = float((got.double() - want.double()).abs().max())
    return err if dtype == torch.int8 else err / max(float(want.abs().max()), 1e-30)


# (case, dtype, shapes, stride, layout): int8_mm takes a (M, K) @ b (K, N);
# tconv the slab x (T_pad, M, C) and w (kt, C, CO); layout is B's (above).
# Cases named "experiment..." (scripts/exp_int8_mxu_r5.py stages AB and C) or
# "stem_conv_s..." are timed, with B K-major as the model passes it (a
# row-major B adds the wrapper's copy; the "rowmajor" cases check that path).
def _gemm_cases(torch):
    i8, bf = torch.int8, torch.bfloat16
    stem = [(38, 344064, 64), (7, 64, 64)]  # B 16, T 32 + 2*3, 112 x 192, C 64
    both = [(d, lay) for d in (i8, bf) for lay in ("kn", "nk")]
    return {
        "int8_mm": [
            *[(name, d, [(4096, 1024), (1024, 1024)], None, lay) for d in (i8, bf)
              for name, lay in (("experiment_4096x1024x1024", "nk"),
                                ("rowmajor_4096x1024x1024", "kn"))],
            ("ragged_1000x333x77", i8, [(1000, 333), (333, 77)], None, "kn"),
            ("ragged_1000x333x77", bf, [(1000, 333), (333, 77)], None, "nk"),
            ("ragged_129x1x130", i8, [(129, 1), (1, 130)], None, "kn"),
            # Mixed-4b branch0 1x1x1 at batch 16: (16, 480, 8, 14, 24) -> 192
            ("mixed4b_1x1x1", i8, [(43008, 480), (480, 192)], None, "nk"),
            # decoder conv4 (5,3,3) s5 im2col at batch 16: (16, 192, 20, 56, 96) -> 64
            ("decoder_conv4_im2col", i8, [(344064, 8640), (8640, 64)], None, "nk"),
            # the model's widths: K 216 (Mixed-4c/4d conv_s) and 147 (the stem
            # conv_s) unpadded take the masked variant; 160 is the padded stem
            *[(name, d, shapes, None, lay) for d, lay in both for name, shapes in (
                ("k216_n24_masked", [(5001, 216), (216, 24)]),
                ("k147_n16_masked", [(3001, 147), (147, 16)]),
                ("k160_n64", [(3001, 160), (160, 64)]),
                ("m1_k160_n24", [(1, 160), (160, 24)]))],
            # the stem conv_s (1,7,7) s2 im2col at batch 16, K padded to 160
            ("stem_conv_s_im2col_11010048x160x64", i8, [(11010048, 160), (160, 64)], None, "nk"),
        ],
        "tconv": [
            ("experiment_stem_7x1x1_s2", i8, stem, 2, "nk"),
            ("experiment_stem_7x1x1_s2", bf, stem, 2, "nk"),
            ("rowmajor_stem_7x1x1_s2", i8, stem, 2, "kn"),
            ("ragged_9x1000x20_co37_s2", i8, [(9, 1000, 20), (3, 20, 37)], 2, "kn"),
            ("ragged_9x1000x20_co37_s2", bf, [(9, 1000, 20), (3, 20, 37)], 2, "nk"),
            # Mixed-5c branch1 conv_t (3,1,1) p1 at batch 16: (16, 384, 4, 7, 12)
            ("mixed5c_conv_t_384", i8, [(6, 1344, 384), (3, 384, 384)], 1, "nk"),
            # C 48 and 208: 32-byte K slices straddle two taps; thin CO; M % 128 != 0
            *[(name, d, shapes, 1, lay) for d, lay in both for name, shapes in (
                ("c48_co16_m5000", [(10, 5000, 48), (3, 48, 16)]),
                ("c208_co24_m5377", [(6, 5377, 208), (3, 208, 24)]))],
        ],
    }


def _time_gemm(torch, name, cuda_fn, plain_fn, args, dtype, iters, host_too) -> dict:
    """Times of the kernel, its plain version and the library call on args,
    with the bound and the operation count. int8_mm's library call is timed
    on B as the kernel gets it and on a row-major copy, and the faster
    counts. With host_too, the kernel and the library are also timed with
    the host's cost per call left in (cuda_ms(hide_host=False))."""
    import torch.nn.functional as F

    from vinet_tpu_torch.tools.timing import cuda_ms

    kernel = lambda: cuda_fn(*args)
    kernel_ms = cuda_ms(kernel, iters)
    plain_ms = cuda_ms(lambda: plain_fn(*args), iters)
    rec = {}
    if name == "int8_mm":
        a, b = args
        m, k = a.shape
        n = b.shape[1]
        ops = 2 * m * k * n
        out_bytes = m * n * 4
        mm = torch._int_mm if dtype == torch.int8 else torch.matmul
        library = "torch._int_mm" if dtype == torch.int8 else "torch.matmul"
        b_row = b.contiguous()
        by_layout = {"b_as_kernel": cuda_ms(lambda: mm(a, b), iters),
                     "b_row_major": cuda_ms(lambda: mm(a, b_row), iters)}
        rec["library_ms_by_b_layout"] = by_layout
        lib = (lambda: mm(a, b)) if by_layout["b_as_kernel"] <= by_layout["b_row_major"] \
            else (lambda: mm(a, b_row))
        library_ms = min(by_layout.values())
    else:
        x, w, st = args
        kt, c, co = w.shape
        t_out = (x.shape[0] - kt) // st + 1
        ops = 2 * t_out * x.shape[1] * kt * c * co
        out_bytes = t_out * x.shape[1] * co * 4
        # stage C's geometry NDHWC (16, 32, 112, 192, 64), as cuDNN's
        # channels-last conv3d in bf16 (there is no int8 conv3d); it writes
        # bf16, half the bytes of the kernel's int32
        xc = torch.randn((16, 64, 32, 112, 192), device="cuda", dtype=torch.bfloat16)
        xc = xc.contiguous(memory_format=torch.channels_last_3d)
        wc = w.to(torch.bfloat16).permute(2, 1, 0)[..., None, None].contiguous()
        lib = lambda: F.conv3d(xc, wc, stride=(st, 1, 1), padding=((kt - 1) // 2, 0, 0))
        library = "F.conv3d bf16 channels_last_3d"
        library_ms = cuda_ms(lib, iters)
    if host_too:
        rec["ms_host_included"] = cuda_ms(kernel, iters, hide_host=False)
        rec["library_ms_host_included"] = cuda_ms(lib, iters, hide_host=False)
    in_bytes = sum(t.numel() * t.element_size() for t in args[:2])
    bound_ms, bound_by = bound(in_bytes + out_bytes, ops, dtype)
    return {"bytes": in_bytes + out_bytes, "ops": ops, "ms": kernel_ms, "plain_ms": plain_ms,
            "library": library, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "achieved_tops": ops / kernel_ms / 1e9, **rec}


def phase_gemm_kernels(torch) -> dict:
    """int8_mm and tconv against their plain versions on every case; times of
    kernel, plain version and library call at the experiment's shapes, in
    int8 and bf16, and at the full-size stem conv_s im2col product. Returns
    the kernels-line rows (int8, the model's path)."""
    from vinet_tpu_torch.ops import int8_mm, tconv

    mods = {"int8_mm": (int8_mm.int8_mm_cuda, int8_mm.int8_mm_plain),
            "tconv": (tconv.tconv_cuda, tconv.tconv_plain)}
    rows = {}
    for name, cases in _gemm_cases(torch).items():
        cuda_fn, plain_fn = mods[name]
        for i, (case, dtype, shapes, stride, layout) in enumerate(cases):
            args = _gemm_operands(torch, dtype, shapes, seed=i)
            args[1] = args[1] if layout == "kn" else int8_mm.k_major_view(args[1])
            if stride is not None:
                args.append(stride)
            got = cuda_fn(*args)
            want = plain_fn(*args)
            torch.cuda.synchronize()
            err = _gemm_err(torch, got, want, dtype)
            tol = 0.0 if dtype == torch.int8 else KERNEL_TOL
            emit({"phase": "kernel_check", "kernel": name, "case": case, "dtype": str(dtype),
                  "shapes": shapes, "stride": stride, "b_layout": layout,
                  "max_abs_err" if dtype == torch.int8 else "max_rel_err": err, "tol": tol})
            check(got.shape == want.shape and err <= tol, f"{name} {case} {dtype}: err {err}")
            del got, want
            if not case.startswith(("experiment", "stem_conv_s")):
                continue
            small = case.startswith("experiment_4096")  # host cost can show here
            rec = _time_gemm(torch, name, cuda_fn, plain_fn, args, dtype, 20 if small else 5,
                             host_too=small)
            emit({"phase": "kernel_time", "kernel": name, "dtype": str(dtype), "case": case,
                  "b_layout": layout, **rec})
            if dtype == torch.int8 and case.startswith("experiment"):
                rows[name] = {
                    "name": name, "route": "cuda", "source": f"vinet_tpu_torch/csrc/{name}.cu",
                    "replaces": {"int8_mm": "scripts/exp_int8_mxu_r5.py:64",
                                 "tconv": "scripts/exp_int8_mxu_r5.py:154"}[name],
                    "max_abs_err": err,
                    **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")}}
            del args
            torch.cuda.empty_cache()
    return rows


def profile_device(torch, fn) -> dict:
    """Where the device time of one fn() goes, by kernel, from torch.profiler:
    device time against wall time, each hand-written kernel's time
    (``kernel_ms``: int8_mm's and tconv's instances of the shared GEMM core
    by their A loaders, Int8MmA and TconvA), the upsample launches, the ten
    costliest kernels and the eight costliest convolutions by input and
    weight shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    convs = sorted(((str(e.input_shapes[:2])[:100], e.device_time_total / 1e3, e.count)
                    for e in prof.key_averages(group_by_input_shape=True)
                    if e.key == "aten::convolution"), key=lambda k: -k[1])
    return {"upsample_trilinear3d_launches": sum(n for k, _, n in kernels
                                                 if "upsample_trilinear3d" in k),
            "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_idle_share": 1 - device_ms / wall_ms,
            "kernel_ms": {name: sum(ms for k, ms, _ in kernels if marker in k)
                          for name, marker in (("saliency_head", "saliency_head"),
                                               ("int8_mm", "Int8MmA"), ("tconv", "TconvA"))},
            "top_kernels": [[k[:80], ms, n] for k, ms, n in kernels[:10]],
            "top_convolutions": [list(c) for c in convs[:8]]}


def profile_window_batch(torch, model, x) -> dict:
    """The model's FLOP count (PyTorch's operators; the hand-written kernels'
    operations are not in it) and where the device time of one window batch
    goes (``profile_device``)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as flops:
        model(x)
    return {"flop_per_clip": flops.get_total_flops() / x.shape[0],
            **profile_device(torch, lambda: model(x))}


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
    launches0 = (head.launches, head.launches_up2x)
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
          "head_launches": head.launches - launches0[0],
          "head_up2x_launches": head.launches_up2x - launches0[1],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(bf16_max <= BF16_MAX_TOL and bf16_mean <= BF16_MEAN_TOL,
          f"bf16 vs f32: max {bf16_max}, mean {bf16_mean}")
    check(cpu_err < CPU_TOL, f"card f32 vs CPU f32: max|err| {cpu_err}")
    check(head.launches_up2x > launches0[1], "the model's head did not launch the fused kernel")
    check(profile["kernel_ms"]["saliency_head"] > 0, "the bf16 profile credits no time to the head")
    check(profile["upsample_trilinear3d_launches"] == UPSAMPLE_LAUNCHES,
          f"{profile['upsample_trilinear3d_launches']} upsample launches in the bf16 window "
          f"batch, expected {UPSAMPLE_LAUNCHES} (conv5 folds one, the head another)")


def _launch_counts() -> dict:
    from vinet_tpu_torch.ops import int8_mm, saliency_head, tconv

    return {"saliency_head": saliency_head.launches,
            "saliency_head_up2x": saliency_head.launches_up2x, "int8_mm": int8_mm.launches,
            "tconv": tconv.launches}


def _reset_launch_counts() -> None:
    from vinet_tpu_torch.ops import int8_mm, saliency_head, tconv

    saliency_head.launches = saliency_head.launches_up2x = int8_mm.launches = tconv.launches = 0


def _map_cc(torch, a, b) -> tuple:
    """Pearson CC of each pair of maps (the saliency CC metric): (mean, min)."""
    a = a.flatten(1).double()
    b = b.flatten(1).double()
    a = a - a.mean(dim=1, keepdim=True)
    b = b - b.mean(dim=1, keepdim=True)
    cc = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))
    return float(cc.mean()), float(cc.min())


def phase_int8_model(torch) -> dict:
    """The int8 path: ViNet(3, 32) with the fixture weights through
    make_inference_fn(dtype="int8") on the bf16 window batch. Returns the
    launch counts of one forward, taken with the counts set to 0 before it."""
    from vinet_tpu_torch.data.pipeline import device_preprocess
    from vinet_tpu_torch.io.weights import load_weights
    from vinet_tpu_torch.models import ViNet
    from vinet_tpu_torch.models.inference import make_inference_fn

    model = ViNet(3, 32)
    model.load_state_dict(load_weights(FIXTURE), strict=True)
    g = torch.Generator(device="cuda").manual_seed(0)  # the model phase's window batch
    x = device_preprocess(torch.randint(0, 256, (16, 32, 224, 384, 3), generator=g,
                                        device="cuda", dtype=torch.uint8))
    small = device_preprocess(torch.randint(0, 256, (1, 32, 128, 192, 3), generator=g,
                                            device="cuda", dtype=torch.uint8))
    t0 = time.perf_counter()
    fn16, _ = make_inference_fn(copy.deepcopy(model), dtype="bfloat16", device="cuda")
    fn8, model8 = make_inference_fn(model, dtype="int8", calib_clips=x[:2], device="cuda")
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    n_quant = sum(type(m).__name__ == "QuantConv3d" for m in model8.modules())

    out16 = fn16(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    out8 = fn8(x)
    torch.cuda.synchronize()
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(out8.shape == (16, 224, 384) and bool(torch.isfinite(out8).all())
          and float(out8.min()) >= 0 and float(out8.max()) <= 1, "int8 model output")
    d = (out8 - out16).abs()
    max_err, mean_err = float(d.max()), float(d.mean())
    cc_mean, cc_min = _map_cc(torch, out8, out16)

    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn8(x)
    torch.cuda.synchronize()
    clips_per_s = iters * x.shape[0] / (time.perf_counter() - t0)
    profile = profile_window_batch(torch, fn8, x)
    profile.pop("flop_per_clip")  # the int8 products are not PyTorch operators
    emit({"phase": "int8_profile", "input": list(x.shape), **profile})

    # the same calibrated model on the CPU (plain routes), at a reduced input
    on_card = fn8(small).cpu()
    with torch.inference_mode():
        on_cpu = copy.deepcopy(model8).cpu()(small.cpu().to(torch.bfloat16)).float()
    dc = (on_card - on_cpu).abs()
    cpu_max, cpu_mean = float(dc.max()), float(dc.mean())
    emit({"phase": "int8_model", "config": "ViNet(3,32) fixture weights, BN folded, int8",
          "input": list(x.shape), "calibration": "first 2 clips of the batch, f32",
          "quantized_convs": n_quant, "prepare_s": prepare_s, "int8_clips_per_s": clips_per_s,
          "peak_mem_gb": peak_gb, "launches": launches,
          "int8_vs_bf16_max_abs_err": max_err, "int8_vs_bf16_mean_abs_err": mean_err,
          "int8_vs_bf16_cc_mean": cc_mean, "int8_vs_bf16_cc_min": cc_min,
          "int8_vs_bf16_tol": [INT8_MAX_TOL, INT8_MEAN_TOL, INT8_CC_MIN],
          "card_int8_vs_cpu_int8_max_abs_err": cpu_max,
          "card_int8_vs_cpu_int8_mean_abs_err": cpu_mean, "cpu_input": list(small.shape),
          "cpu_tol": [INT8_CPU_MAX_TOL, INT8_CPU_MEAN_TOL]})
    check(n_quant == 81, f"{n_quant} quantized convs, expected 81")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the int8 path")
    for k in ("int8_mm", "tconv", "saliency_head"):  # a renamed kernel would be credited 0 ms
        check(profile["kernel_ms"][k] > 0, f"the int8 profile credits no time to {k}")
    check(max_err <= INT8_MAX_TOL and mean_err <= INT8_MEAN_TOL and cc_min >= INT8_CC_MIN,
          f"int8 vs bf16: max {max_err}, mean {mean_err}, cc min {cc_min}")
    check(cpu_max <= INT8_CPU_MAX_TOL and cpu_mean <= INT8_CPU_MEAN_TOL,
          f"card int8 vs CPU int8: max {cpu_max}, mean {cpu_mean}")
    return launches


def _blob(size: tuple, f: int, n_frames: int):
    """(H, W) in [0, 1]: frame f's Gaussian blob, crossing the frame."""
    import numpy as np

    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h / 2, w * (0.2 + 0.6 * f / n_frames)
    return np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 40.0**2))


def _video_frames(rng, n_frames: int, size: tuple):
    """(n_frames, H, W, 3) uint8: a bright blob crossing a noisy frame."""
    import numpy as np

    frames = np.empty((n_frames, *size, 3), np.uint8)
    for f in range(n_frames):
        blob = 175.0 * _blob(size, f, n_frames)
        frames[f] = np.clip(rng.integers(0, 80, (*size, 3)) + blob[..., None], 0, 255)
    return frames


def _write_videos(root: str, n_videos: int, n_frames: int, size: tuple,
                  maps: bool = False) -> None:
    """DHF1K layout: <root>/<video>/images/%04d.png, and with maps the blob
    of each frame as its GT map, maps/%04d.png."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    for v in range(n_videos):
        d = os.path.join(root, "%03d" % (v + 1))
        os.makedirs(os.path.join(d, "images"))
        if maps:
            os.makedirs(os.path.join(d, "maps"))
        for f, img in enumerate(_video_frames(rng, n_frames, size)):
            Image.fromarray(img).save(os.path.join(d, "images", "%04d.png" % (f + 1)))
            if maps:
                gt = np.round(255.0 * _blob(size, f, n_frames)).astype(np.uint8)
                Image.fromarray(gt).save(os.path.join(d, "maps", "%04d.png" % (f + 1)))


def _check_maps_written(data: str, out: str, n_videos: int, size: tuple) -> None:
    import numpy as np
    from PIL import Image

    for v in range(n_videos):
        name = "%03d" % (v + 1)
        frames = sorted(os.listdir(os.path.join(data, name, "images")))
        written = sorted(os.listdir(os.path.join(out, name)))
        check(written == frames, f"video {name}: {len(written)} maps for {len(frames)} frames")
        m = np.asarray(Image.open(os.path.join(out, name, written[-1])))
        check(m.shape == size and m.dtype == np.uint8 and m.min() == 0 and m.max() == 255,
              f"video {name}: map {m.shape} {m.dtype} [{m.min()}, {m.max()}]")


def phase_cli(torch, keep: str) -> dict:
    """The main path: the port's generate_result CLI on the card. Its frames
    and maps are copied to keep (data/, out/) for phase parallel."""
    from vinet_tpu_torch.cli.generate_result import main as generate_main

    n_videos, n_frames, size = 2, 80, (360, 640)
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        _write_videos(data, n_videos, n_frames, size)
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        rc = generate_main(["--path_indata", data, "--save_path", out,
                            "--file_weight", FIXTURE, "--device", "cuda"])
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        check(rc == 0, f"generate_result returned {rc}")
        _check_maps_written(data, out, n_videos, size)
        shutil.copytree(tmp, keep)
    n_maps = n_videos * n_frames  # one window per map, flipped for the first 31
    emit({"phase": "cli", "videos": n_videos, "frames": n_frames, "frame_size": list(size),
          "maps": n_maps, "window_batches": n_videos * -(-n_frames // 16),
          "seconds": seconds, "maps_per_s": n_maps / seconds, "launches": launches})
    check(launches["saliency_head_up2x"] > 0,
          "the fused head kernel was not launched on the main path")
    return launches


def _fixture_vinet():
    """ViNet(3, 32) with the fixture weights, on the CPU, unprepared (the
    predictors fold, cast and move it)."""
    from vinet_tpu_torch.io.weights import load_weights
    from vinet_tpu_torch.models import ViNet

    model = ViNet(3, 32)
    model.load_state_dict(load_weights(FIXTURE), strict=True)
    return model


def _require_head(launches: dict, path: str) -> None:
    check(launches["saliency_head_up2x"] > 0, f"the fused head kernel was not launched on {path}")


# conv-after-upsample geometries of a window batch of 16 at 224 x 384: (x,
# w, stride_t); conv3's and conv4's up-mixing taps in the streaming decode,
# and conv5 in every decoder
FOLD_CASES = {"conv3_taps": ((16, 480, 4, 14, 24), (192, 480, 4, 3, 3), 1),
              "conv4_taps": ((16, 192, 4, 28, 48), (64, 192, 4, 3, 3), 1),
              "conv5": ((16, 64, 4, 56, 96), (32, 64, 2, 3, 3), 2)}


def phase_phasefold(torch) -> dict:
    """Conv after a 2x upsample, both routes: folded (``ops/phasefold.py``,
    the weights folded beforehand, as the decoder keeps them, and for conv5
    also folded on every call) and upsample then conv. Per geometry an f32 check
    (max|err| over the largest output) and bf16 times (folded, upsample,
    upsample, folded), with cuDNN's heuristics and again with its benchmark
    mode, and the bound of the conv's work; then the decoder's tail on a
    bf16 z4 with the counts at 0."""
    import torch.nn.functional as F

    from vinet_tpu_torch.ops.phasefold import FoldedConvUp2x, conv_after_up2x
    from vinet_tpu_torch.ops.upsample import upsample2x_hw
    from vinet_tpu_torch.tools.timing import cuda_ms

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    cases = {}
    with torch.inference_mode():
        for name, (xs, ws, st) in FOLD_CASES.items():
            x = torch.relu(torch.randn(xs, generator=g, device="cuda"))
            w = torch.randn(ws, generator=g, device="cuda") / (ws[1] * ws[2] * 9) ** 0.5

            def routes(x, w):
                fold = FoldedConvUp2x(w)
                r = {"folded": lambda: fold(x, stride_t=st),
                     "upsample_then_conv": lambda: F.conv3d(upsample2x_hw(x), w,
                                                            stride=(st, 1, 1), padding=(0, 1, 1))}
                if name == "conv5":
                    r["folded_per_call"] = lambda: conv_after_up2x(x, w, stride_t=st)
                return r

            f32 = {k: fn() for k, fn in routes(x, w).items()}
            ref = f32["upsample_then_conv"]
            err = float((f32["folded"] - ref).abs().max() / ref.abs().max())
            out_shape = list(f32["folded"].shape)
            del f32
            bf16 = routes(x.bfloat16(), w.bfloat16())
            ms = {}
            for benchmark in (False, True):
                torch.backends.cudnn.benchmark = benchmark
                key = "cudnn_benchmark" if benchmark else "cudnn_default"
                ms[key] = {k: [] for k in bf16}
                order = [k for k in bf16 if k != "upsample_then_conv"]
                for k in order + ["upsample_then_conv"] * 2 + order[::-1]:
                    ms[key][k].append(cuda_ms(bf16[k], 20))
            torch.backends.cudnn.benchmark = False
            out_elems = 1
            for d in out_shape:
                out_elems *= d
            bytes_moved = (x.numel() + out_elems + w.numel()) * 2
            bound_ms, bound_by = bound(bytes_moved, 2 * out_elems * ws[1] * ws[2] * 9,
                                       torch.bfloat16)
            cases[name] = {"x": list(xs), "w": list(ws), "stride_t": st, "out": out_shape,
                           "f32_max_rel_err": err, "bf16_ms": ms, "bound_ms": bound_ms,
                           "bound_by": bound_by}
            del x, w, bf16
            torch.cuda.empty_cache()

        dec = _fixture_vinet().decoder.to("cuda", torch.bfloat16).eval()
        z4 = torch.relu(torch.randn(FOLD_CASES["conv5"][0], generator=g, device="cuda"))
        torch.cuda.synchronize()
        _reset_launch_counts()
        maps = dec.tail(z4.bfloat16())
        torch.cuda.synchronize()
        launches = _launch_counts()
    rec = {"phase": "phasefold", "cases": cases, "tol": FOLD_TOL,
           "routes_taken": {"decoder_conv5": "folded", "streaming_conv3_taps": "folded",
                            "streaming_conv4_taps": "upsample_then_conv"},
           "tail_maps": list(maps.shape), "launches": launches}
    emit(rec)
    for name, c in cases.items():
        check(c["f32_max_rel_err"] <= FOLD_TOL,
              f"{name}: folded vs upsample + conv in f32: {c['f32_max_rel_err']}")
    check(tuple(maps.shape) == (16, 224, 384) and bool(torch.isfinite(maps).all()),
          "decoder tail output")
    _require_head(launches, "the decoder's tail")
    return rec


def _part_times(torch, parts) -> dict:
    """Run parts [(name, fn)] in order with a CUDA event between each; the
    device-timeline ms of each (queued back to back, so a part the host
    cannot feed fast enough shows its gaps)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
    ev[0].record()
    for i, (_, fn) in enumerate(parts):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return {name: ev[i].elapsed_time(ev[i + 1]) for i, (name, _) in enumerate(parts)}


def _maps_err(a: dict, b: dict, frames) -> tuple:
    """(max, mean) over frames of |a - b| for two {frame: map} results."""
    import numpy as np

    d = [np.abs(a[i].astype(np.float64) - b[i]) for i in frames]
    return float(max(x.max() for x in d)), float(np.mean([x.mean() for x in d]))


def phase_streaming(torch) -> dict:
    """--streaming end to end, one chunk's device time, and its accuracy."""
    import numpy as np

    from vinet_tpu_torch.cli.generate_result import main as generate_main
    from vinet_tpu_torch.inference import StreamingPredictor
    from vinet_tpu_torch.inference.streaming import dense_decoder_front, streaming_pyramid
    from vinet_tpu_torch.data.pipeline import device_preprocess

    torch.backends.cudnn.allow_tf32 = False
    n_videos, n_frames, size = 2, 160, (224, 384)
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        _write_videos(data, n_videos, n_frames, size)
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        rc = generate_main(["--path_indata", data, "--save_path", out, "--streaming",
                            "--chunk", "128", "--file_weight", FIXTURE, "--device", "cuda"])
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        check(rc == 0, f"generate_result --streaming returned {rc}")
        _check_maps_written(data, out, n_videos, size)

    # one 128-frame chunk: its 97 window starts in 7 batches of 16
    pred = StreamingPredictor(_fixture_vinet(), chunk=128, batch=16, device="cuda")
    frames = torch.from_numpy(_video_frames(np.random.default_rng(1), 128, size)).cuda()[None]
    batches = [list(range(lo, min(97, lo + 16))) for lo in range(0, 97, 16)]
    with torch.inference_mode():
        state = {}

        def timeline():
            x = device_preprocess(frames).to(pred.dtype).permute(0, 4, 1, 2, 3).contiguous()
            state["tl"] = streaming_pyramid(pred.model.backbone, x)

        def front():
            state["dense"] = dense_decoder_front(pred.model.decoder, state["tl"])

        def decode():
            state["maps"] = [pred._decode(state["tl"], state["dense"], pred._starts(b))[: len(b)]
                             for b in batches]

        def post():
            for m in state["maps"]:
                pred._post(m, size, True).cpu()

        parts = [("timeline", timeline), ("dense_front", front), ("window_decode", decode),
                 ("post", post)]
        _part_times(torch, parts)  # warm-up
        part_ms = _part_times(torch, parts)
        profile = profile_device(torch, lambda: _part_times(torch, parts))

    # accuracy: card bf16 vs card f32, and card f32 vs CPU f32 at a reduced size
    video = _video_frames(np.random.default_rng(2), 96, size)
    got16 = dict(pred.predict_video(video))
    got32 = dict(StreamingPredictor(_fixture_vinet(), chunk=128, batch=16, dtype=torch.float32,
                                    device="cuda").predict_video(video))
    bf16_max, bf16_mean = _maps_err(got16, got32, range(96))
    small = _video_frames(np.random.default_rng(3), 72, (64, 64))
    card = dict(StreamingPredictor(_fixture_vinet(), chunk=72, batch=16, dtype=torch.float32,
                                   device="cuda").predict_video(small))
    cpu = dict(StreamingPredictor(_fixture_vinet(), chunk=72, batch=16, dtype=torch.float32,
                                  device="cpu").predict_video(small))
    cpu_max, _ = _maps_err(card, cpu, range(72))
    rec = {"phase": "streaming", "videos": n_videos, "frames": n_frames,
           "frame_size": list(size), "chunk": 128, "window_batch": 16, "dtype": "bfloat16",
           "seconds": seconds, "maps_per_s": n_videos * n_frames / seconds,
           "launches": launches, "chunk_part_ms": part_ms,
           "chunk_maps_per_s": 97 / sum(part_ms.values()) * 1e3, "chunk_profile": profile,
           "bf16_vs_f32_max_abs_err": bf16_max, "bf16_vs_f32_mean_abs_err": bf16_mean,
           "bf16_tol": [BF16_MAX_TOL, BF16_MEAN_TOL],
           "card_f32_vs_cpu_f32_max_abs_err": cpu_max, "cpu_input": [72, 64, 64, 3],
           "cpu_tol": CPU_TOL}
    emit(rec)
    check(bf16_max <= BF16_MAX_TOL and bf16_mean <= BF16_MEAN_TOL,
          f"streaming bf16 vs f32: max {bf16_max}, mean {bf16_mean}")
    check(cpu_max < CPU_TOL, f"streaming card f32 vs CPU f32: max|err| {cpu_max}")
    check(profile["kernel_ms"]["saliency_head"] > 0, "the chunk profile credits no time to the head")
    _require_head(launches, "the streaming path")
    return rec


def phase_live(torch) -> dict:
    """The live server at micro 16 over one stream of 224 x 384 frames."""
    import numpy as np

    from vinet_tpu_torch.inference import LiveStreamingPredictor, StreamingPredictor
    from vinet_tpu_torch.tools.timing import cuda_ms

    torch.backends.cudnn.allow_tf32 = False
    size, n, micro = (224, 384), 240, 16
    frames = _video_frames(np.random.default_rng(4), n, size)

    # f32: live interior maps against the card's chunked maps; one chunk
    # covers the stream (no seam) and is the live warm-up's flipped chunk
    chunked = dict(StreamingPredictor(_fixture_vinet(), chunk=n, batch=16,
                                      dtype=torch.float32, device="cuda").predict_video(frames))
    live32 = LiveStreamingPredictor(_fixture_vinet(), micro=micro, span=n + 8, batch=16,
                                    dtype=torch.float32, device="cuda", warmup_chunk=n)
    got = [m for lo in range(0, n, micro) for m in live32.feed(frames[lo: lo + micro])]
    got += list(live32.flush())
    check([i for i, _ in got] == list(range(n)), "live: frames emitted out of order or missed")
    live_maps = dict(got)
    # interior: past the stream start (zero tails against zero padding) and
    # before the flush tail (the repeated last frame)
    d = [float(np.abs(live_maps[i] - chunked[i]).max()) for i in range(96, n - 70)]
    warm = max(float(np.abs(live_maps[i] - chunked[i]).max()) for i in range(31))
    del live32

    # bf16: ms a feed, maps/s, lag, with the counts at 0 before the run
    live = LiveStreamingPredictor(_fixture_vinet(), micro=micro, span=160, batch=16,
                                  device="cuda")
    for lo in range(0, n, micro):  # warm-up stream: cuDNN picks its algorithms
        list(live.feed(frames[lo: lo + micro]))
    list(live.flush())
    live.reset()
    torch.cuda.synchronize()
    _reset_launch_counts()
    feed_ms, lags = [], []
    t0 = time.perf_counter()
    for lo in range(0, n, micro):
        t1 = time.perf_counter()
        for i, _ in live.feed(frames[lo: lo + micro]):
            lags.append(lo + micro - 1 - i)  # frames that arrived after frame i
        feed_ms.append((time.perf_counter() - t1) * 1e3)
    n_flushed = len(list(live.flush()))
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    steady = lags[31:]  # after the warm-up pass's burst
    with torch.inference_mode():
        x = torch.from_numpy(frames[None, :micro]).cuda()
        starts = live._starts(list(range(16)))
        shifted = [(live._bufs[k], micro // r) for k, r in (
            ("y3", 2), ("y2", 2), ("y1", 4), ("y0", 8), ("c1u", 8), ("c2y", 4), ("c3y", 2),
            ("c4y", 2))]

        def shift():  # the rolling buffers' shift-in of one microbatch
            for b, k in shifted:
                torch.cat([b[:, :, k:], b[:, :, -k:]], dim=2)

        part_ms = {"advance": cuda_ms(lambda: live._advance(x), 10),
                   "window_decode": cuda_ms(lambda: live._decode(*live._views(), starts), 10),
                   "rolling_shift": cuda_ms(shift, 10)}
    rec = {"phase": "live", "frames": n, "frame_size": list(size), "micro": micro, "batch": 16,
           "span": 160, "dtype": "bfloat16", "seconds": seconds, "maps_per_s": n / seconds,
           "feed_ms": {"median": float(np.median(feed_ms)), "max": max(feed_ms),
                       "steady_mean": float(np.mean(feed_ms[8:]))},
           "lag_frames": {"median": float(np.median(steady)), "max": max(steady),
                          "min": min(steady)},
           "flushed_maps": n_flushed, "launches": launches, "part_ms": part_ms,
           "f32_interior_vs_chunked_max_abs_err": max(d),
           "f32_interior_vs_chunked_median_abs_err": float(np.median(d)),
           "f32_warmup_vs_chunked_max_abs_err": warm,
           "tol": [LIVE_MAX_TOL, LIVE_MEDIAN_TOL]}
    emit(rec)
    check(max(d) < LIVE_MAX_TOL and float(np.median(d)) < LIVE_MEDIAN_TOL and warm < 1e-5,
          f"live vs chunked interior: max {max(d)}, median {np.median(d)}, warm-up {warm}")
    _require_head(launches, "the live path")
    return rec


def phase_serve(torch, keep: str) -> dict:
    """cli.serve --streams 4 --live_micro 32, and one serve step's device
    time. Its frames and maps are copied to keep (data/, out/) for phase
    parallel."""
    import numpy as np

    from vinet_tpu_torch.cli.generate_result import live_span
    from vinet_tpu_torch.cli.serve import main as serve_main
    from vinet_tpu_torch.inference import MultiLiveServer

    streams, micro, n_frames, size = 4, 32, 160, (224, 384)
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        _write_videos(data, streams, n_frames, size)
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        rc = serve_main(["--path_indata", data, "--save_path", out, "--streams", str(streams),
                         "--live_micro", str(micro), "--file_weight", FIXTURE, "--device", "cuda"])
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        check(rc == 0, f"serve returned {rc}")
        _check_maps_written(data, out, streams, size)
        shutil.copytree(tmp, keep)

    server = MultiLiveServer(_fixture_vinet(), streams=streams, micro=micro, batch=micro,
                             span=live_span(32, micro), device="cuda")
    frames = np.stack([_video_frames(np.random.default_rng(10 + s), 128, size)
                       for s in range(streams)])
    for lo in range(0, 128, micro):
        list(server.feed(frames[:, lo: lo + micro]))
    with torch.inference_mode():
        x = torch.from_numpy(frames[:, :micro]).cuda()
        starts = server._starts(list(range(micro)))
        parts = [("advance", lambda: server._advance(x)),
                 ("window_decode", lambda: server._decode(*server._views(), starts))]
        _part_times(torch, parts)
        part_ms = _part_times(torch, parts)
        profile = profile_device(torch, lambda: _part_times(torch, parts))
    rec = {"phase": "serve", "streams": streams, "live_micro": micro, "frames": n_frames,
           "frame_size": list(size), "dtype": "bfloat16", "seconds": seconds,
           "maps_per_s": streams * n_frames / seconds, "launches": launches,
           "step_part_ms": part_ms,
           "step_maps_per_s": streams * micro / sum(part_ms.values()) * 1e3,
           "step_profile": profile}
    emit(rec)
    check(profile["kernel_ms"]["saliency_head"] > 0, "the serve step credits no time to the head")
    _require_head(launches, "the serve path")
    return rec


# card f32 vs CPU f32 on one train step of ViNet(3, 8): the loss, and the
# whole gradient in relative L2. Train-mode BatchNorm after every conv makes
# the gradient chaotic in f32: on the CPU the port's own f32 gradient lies
# 1.2 % (L2) from its float64 one at this shape (tests/test_torch_training.py)
TRAIN_CPU_LOSS_TOL, TRAIN_CPU_GRAD_L2_TOL = 1e-4, 0.1
# grad_accum 2 against the mean of the two microbatches' own gradients, the
# same operations in the same order (cuDNN deterministic): relative L2
ACCUM_GRAD_L2_TOL = 1e-3


def _train_batch(torch, b: int, t: int, h: int, w: int, seed: int) -> dict:
    """A fixed synthetic batch on the card: random uint8 clips, normalised,
    and one Gaussian blob a map as GT."""
    from vinet_tpu_torch.data.pipeline import device_preprocess

    g = torch.Generator(device="cuda").manual_seed(seed)
    clip = device_preprocess(torch.randint(0, 256, (b, t, h, w, 3), generator=g, device="cuda",
                                           dtype=torch.uint8))
    cy = torch.rand((b, 1, 1), generator=g, device="cuda") * h
    cx = torch.rand((b, 1, 1), generator=g, device="cuda") * w
    yy = torch.arange(h, device="cuda").view(1, h, 1)
    xx = torch.arange(w, device="cuda").view(1, 1, w)
    gt = torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * (h / 8) ** 2))
    return {"clip": clip, "gt": gt}


def _bn_stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items() if "running" in k}


def _grads(model) -> dict:
    return {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}


def _grad_errs(torch, got: dict, want: dict) -> tuple:
    """(relative L2 of the whole gradient, worst leaf's max|err| over the
    leaf's largest value, that leaf)."""
    g = torch.cat([got[k].flatten() for k in sorted(want)])
    r = torch.cat([want[k].flatten() for k in sorted(want)])
    leaf = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30))
            for k in want}
    worst = max(leaf, key=leaf.get)
    return float((g - r).norm() / r.norm()), leaf[worst], worst


def _autograd_guard(torch) -> dict:
    """Each CUDA entry refuses inputs that require grad: {entry: raised}."""
    from vinet_tpu_torch.ops import int8_mm, saliency_head, tconv

    dev = "cuda"
    z5 = torch.rand((1, 32, 2, 8, 8), device=dev, requires_grad=True)
    w6, w7 = torch.rand((32, 32, 2, 1, 1), device=dev), torch.rand((1, 32, 1, 1, 1), device=dev)
    b7 = torch.rand((1,), device=dev)
    a = torch.rand((16, 32), device=dev).bfloat16().requires_grad_()
    b = torch.rand((32, 16), device=dev).bfloat16()
    x = torch.rand((4, 16, 32), device=dev).bfloat16().requires_grad_()
    w = torch.rand((3, 32, 16), device=dev).bfloat16()
    calls = {"saliency_head_up2x_cuda": lambda: saliency_head.saliency_head_up2x_cuda(
                 z5, w6, None, w7, b7),
             "saliency_head_cuda": lambda: saliency_head.saliency_head_cuda(z5, w6, None, w7, b7),
             "int8_mm_cuda": lambda: int8_mm.int8_mm_cuda(a, b),
             "tconv_cuda": lambda: tconv.tconv_cuda(x, w)}
    raised = {}
    before = _launch_counts()
    for name, call in calls.items():
        try:
            call()
            raised[name] = False
        except RuntimeError as e:
            raised[name] = "no backward" in str(e)
    check(_launch_counts() == before, "a CUDA entry launched under autograd")
    return raised


def _cli_train(argv: list) -> None:
    from vinet_tpu_torch.cli.train import main as train_main

    rc = train_main(argv)
    check(rc == 0, f"cli.train {' '.join(argv)} returned {rc}")


def phase_train(torch, card: str, keep_checkpoint: str) -> dict:
    """Training on the card: full-width bf16 steps, the eval step through the
    fused head, the autograd guard, card against CPU, grad_accum, and the
    train CLI with validation, checkpoint, resume and streaming fine-tuning.
    The train CLI's checkpoint directory is copied to keep_checkpoint."""
    import numpy as np

    from vinet_tpu_torch.io.checkpoint import latest_step, restore_raw
    from vinet_tpu_torch.io.weights import load_weights
    from vinet_tpu_torch.models import ViNet
    from vinet_tpu_torch.training import LossConfig, loss_func
    from vinet_tpu_torch.training.trainer import (init_train_state, make_eval_step,
                                                  make_train_step)

    cfg = LossConfig()
    # 1. ViNet(3, 32), fixture weights, BN unfolded, bf16 convs, Adam 1e-4, batch 8
    model = _fixture_vinet().cuda()
    batch = _train_batch(torch, 8, 32, 224, 384, seed=0)
    ts = init_train_state(model, 1e-4)
    step = make_train_step(cfg, compute_dtype=torch.bfloat16)
    bn0 = _bn_stats(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    losses, step_ms = [], []
    for i in range(7):  # 2 warm-up steps, then 5 timed
        t0 = time.perf_counter()
        _, metrics = step(ts, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    step_launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grads_ok = all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
    n_params = sum(1 for _ in model.parameters())
    bn_moved = sum(not torch.equal(v, bn0[k]) for k, v in _bn_stats(model).items())
    timed_ms = step_ms[2:]
    profile = profile_device(torch, lambda: step(ts, batch))
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as flops:  # forward and backward
        step(ts, batch)
    step_flop = flops.get_total_flops()

    # 2. the eval step on the trained model: the fused head kernel
    _reset_launch_counts()
    metrics, pred = make_eval_step(cfg)(ts, batch)
    eval_launches = _launch_counts()
    eval_loss = float(metrics["loss"])
    del model, ts, step, batch, pred
    torch.cuda.empty_cache()

    # 3. the CUDA entries refuse autograd
    guard = _autograd_guard(torch)

    # 4. one f32 step of ViNet(3, 8) at (2, 8, 64, 96), card against CPU
    torch.manual_seed(0)
    small = ViNet(3, 8)
    sbatch = _train_batch(torch, 4, 8, 64, 96, seed=1)
    half = {k: v[:2] for k, v in sbatch.items()}
    runs = {}
    for dev in ("cpu", "cuda"):
        ts_d = init_train_state(copy.deepcopy(small).to(dev), 1e-4)
        _, m = make_train_step(cfg)(ts_d, {k: v.to(dev) for k, v in half.items()})
        runs[dev] = (float(m["loss"]), _grads(ts_d.model))
    cpu_loss_err = abs(runs["cuda"][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
    cpu_l2, cpu_leaf, cpu_leaf_name = _grad_errs(torch, runs["cuda"][1], runs["cpu"][1])

    # 5. grad_accum 2 against the mean of the two microbatches, on the card
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ts_a = init_train_state(copy.deepcopy(small).cuda(), 0.0)  # lr 0: read the gradients
        make_train_step(cfg, grad_accum=2)(ts_a, sbatch)
        ref = copy.deepcopy(small).cuda().train()
        mean = None
        for i in (0, 2):
            ref.zero_grad()
            loss_func(ref(sbatch["clip"][i:i + 2]), sbatch["gt"][i:i + 2], cfg).backward()
            g = _grads(ref)
            mean = g if mean is None else {k: (mean[k] + g[k]) / 2 for k in g}
        accum_l2, accum_leaf, accum_leaf_name = _grad_errs(torch, _grads(ts_a.model), mean)
    finally:
        torch.backends.cudnn.deterministic = det

    # 6. the train CLI: validation, checkpoint, resume, streaming fine-tuning
    clis = {}
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, val_dir = os.path.join(tmp, "train"), os.path.join(tmp, "val")
        ck, best, ft = (os.path.join(tmp, n) for n in ("ck", "best.pt", "ft.pt"))
        ck_npz, best_npz = os.path.join(tmp, "ck_npz"), os.path.join(tmp, "best.npz")
        _write_videos(train_dir, 24, 64, (112, 192), maps=True)
        _write_videos(val_dir, 2, 64, (180, 320), maps=True)
        common = ["--train_path_data", train_dir, "--val_path_data", val_dir, "--bf16",
                  "--no_epochs", "1", "--no_workers", "8", "--device", "cuda"]
        for name, extra in (
                ("train", ["--batch_size", "8", "--max_steps_per_epoch", "3", "--load_weight",
                           FIXTURE, "--checkpoint_dir", ck, "--model_val_path", best]),
                ("resume", ["--batch_size", "8", "--max_steps_per_epoch", "3", "--load_weight",
                            FIXTURE, "--checkpoint_dir", ck, "--model_val_path", best,
                            "--resume"]),
                ("streaming_ft", ["--streaming_ft", "--ft_chunk", "64", "--ft_windows", "16",
                                  "--max_steps_per_epoch", "2", "--load_weight", best,
                                  "--model_val_path", ft]),
                ("npz", ["--batch_size", "8", "--max_steps_per_epoch", "1", "--load_weight",
                         FIXTURE, "--checkpoint_dir", ck_npz, "--model_val_path", best_npz])):
            torch.cuda.synchronize()
            _reset_launch_counts()
            t0 = time.perf_counter()
            _cli_train(common + extra)
            clis[name] = {"seconds": time.perf_counter() - t0, "launches": _launch_counts(),
                          "latest_step": latest_step(ck)}
        shutil.copytree(ck, keep_checkpoint)  # the accuracy phase exports it
        before, after = torch.load(best, weights_only=True), torch.load(ft, weights_only=True)
        ft_bn_changed = sum(not torch.equal(before[k], after[k]) for k in before
                            if "running" in k)
        ft_weights_changed = sum(not torch.equal(before[k], after[k]) for k in before
                                 if k.endswith("weight"))
        # --model_val_path x.npz: the JAX package's trees, read back by
        # load_weights strictly, equal to the epoch's checkpointed model
        npz = ViNet(3, 32)
        npz.load_state_dict(load_weights(best_npz), strict=True)
        want = restore_raw(ck_npz)["model"]
        clis["npz"]["tensors_differing"] = sum(
            not torch.equal(v, want[k]) for k, v in npz.state_dict().items()
            if not k.endswith("num_batches_tracked"))
        with np.load(best_npz) as f:
            clis["npz"]["members"] = len(f.files)

    rec = {"phase": "train", "card": card,
           "config": "ViNet(3,32) fixture weights, BN unfolded, bf16 convs, f32 masters, "
                     "Adam 1e-4", "input": [8, 32, 224, 384, 3],
           "losses": losses, "step_ms": step_ms, "step_ms_median": float(np.median(timed_ms)),
           "clips_per_s": 8 * 1e3 / float(np.median(timed_ms)), "peak_mem_gb": peak_gb,
           "step_flop": step_flop,
           "achieved_tflop_per_s": step_flop / float(np.median(timed_ms)) / 1e9,
           "step_profile": profile, "step_launches": step_launches,
           "params_with_finite_grad": grads_ok, "params": n_params,
           "bn_stats_moved": bn_moved, "bn_stats": len(bn0),
           "eval_launches": eval_launches, "eval_loss": eval_loss, "autograd_guard": guard,
           "card_vs_cpu_f32": {"model": "ViNet(3,8) seeded init", "input": [2, 8, 64, 96, 3],
                               "loss_rel_err": cpu_loss_err, "grad_rel_l2": cpu_l2,
                               "worst_leaf_rel_err": cpu_leaf, "worst_leaf": cpu_leaf_name,
                               "tol": [TRAIN_CPU_LOSS_TOL, TRAIN_CPU_GRAD_L2_TOL]},
           "grad_accum_2_vs_microbatch_mean": {"input": [4, 8, 64, 96, 3], "grad_rel_l2": accum_l2,
                                               "worst_leaf_rel_err": accum_leaf,
                                               "worst_leaf": accum_leaf_name,
                                               "tol": ACCUM_GRAD_L2_TOL},
           "cli": clis, "streaming_ft_bn_stats_changed": ft_bn_changed,
           "streaming_ft_weights_changed": ft_weights_changed,
           "launches": clis["train"]["launches"]}
    emit(rec)
    check(all(np.isfinite(losses)), f"train losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(grads_ok, "a parameter has no gradient or a gradient that is not finite")
    check(bn_moved == len(bn0), f"{len(bn0) - bn_moved} BN statistics did not move")
    check(step_launches["saliency_head"] == 0, f"the train steps launched the head: {step_launches}")
    _require_head(eval_launches, "the eval step")
    check(all(guard.values()), f"autograd guard: {guard}")
    check(cpu_loss_err <= TRAIN_CPU_LOSS_TOL and cpu_l2 <= TRAIN_CPU_GRAD_L2_TOL,
          f"card vs CPU f32 step: loss {cpu_loss_err}, gradient L2 {cpu_l2}")
    check(accum_l2 <= ACCUM_GRAD_L2_TOL, f"grad_accum 2 vs microbatch mean: L2 {accum_l2}")
    check(clis["train"]["latest_step"] == 3 and clis["resume"]["latest_step"] == 6,
          f"checkpoint steps {clis['train']['latest_step']}, {clis['resume']['latest_step']}")
    for name in clis:
        _require_head(clis[name]["launches"], f"cli.train {name}'s validation")
    check(ft_bn_changed == 0, f"streaming fine-tuning changed {ft_bn_changed} BN statistics")
    check(ft_weights_changed > 0, "streaming fine-tuning changed no weight")
    check(clis["npz"]["members"] > 300 and clis["npz"]["tensors_differing"] == 0,
          f"train --model_val_path best.npz: {clis['npz']}")
    return rec


# accuracy bounds: the JAX package's own (tests/test_streaming_ft_artifact.py
# :44-49 on the blob video, :73-78 on the fixture suite), held in bf16 here
MODES_MIN = {"parity_cc": 0.70, "streaming_cc": 0.65}  # strictly above
MODES_AT_LEAST = {"cc_delta": -0.08, "agreement_cc": 0.98}
KIND_DELTA_MIN, KIND_AGREEMENT_MIN = -0.10, 0.97
SUITE_DELTA_MIN, SUITE_DELTA_MEAN_MIN = -0.10, -0.08
# diem_val's per-frame CC (f32 maps) against eval_diem's on the same model's
# maps written as u8 JPEGs at quality 100: CC is blind to the min-max
# normalisation, so only the 8-bit rounding and the JPEG round trip differ
DIEM_CC_TOL = 0.01
ALL_METRICS = ("cc", "sim", "kldiv", "nss", "aucj", "aucb", "sauc", "ig", "emd")


def _run_cli(main, argv: list) -> tuple:
    """(stdout lines, seconds) of a CLI's main; fails unless it returns 0."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    seconds = time.perf_counter() - t0
    check(rc in (0, None), f"{main.__module__} {' '.join(argv)} returned {rc}")
    return buf.getvalue().splitlines(), seconds


def _overall(lines: list, header: str) -> dict:
    """{metric: value} of the 'name: value' lines after header."""
    start = lines.index(header) + 1
    out = {}
    for line in lines[start:]:
        if line.startswith("==="):
            break
        k, v = line.split(": ")
        out[k] = float(v)
    return out


def _write_stavis(dhf1k_val: str, root: str) -> list:
    """The STAViS layout of a DHF1K-layout set's videos (tests/fixtures.py's
    make_sound_dataset): video_frames/DIEM/<v>/img_%05d.jpg,
    annotations/DIEM/<v>/maps/eyeMap_%05d.jpg (JPEG quality 100),
    fixMap_%05d.mat (scipy.io.savemat) and the DIEM test fold list."""
    import numpy as np
    from PIL import Image
    from scipy.io import savemat

    names = sorted(os.listdir(dhf1k_val))
    os.makedirs(os.path.join(root, "fold_lists"))
    with open(os.path.join(root, "fold_lists", "DIEM_list_test_fps.txt"), "w") as fh:
        for v in names:
            src = os.path.join(dhf1k_val, v)
            fdir = os.path.join(root, "video_frames", "DIEM", v)
            adir = os.path.join(root, "annotations", "DIEM", v)
            os.makedirs(fdir)
            os.makedirs(os.path.join(adir, "maps"))
            frames = sorted(os.listdir(os.path.join(src, "images")))
            for f, name in enumerate(frames, start=1):
                Image.open(os.path.join(src, "images", name)).save(
                    os.path.join(fdir, "img_%05d.jpg" % f), quality=100)
                Image.open(os.path.join(src, "maps", name)).save(
                    os.path.join(adir, "maps", "eyeMap_%05d.jpg" % f), quality=100)
                fix = np.asarray(Image.open(os.path.join(src, "fixation", name))) > 0
                savemat(os.path.join(adir, "fixMap_%05d.mat" % f),
                        {"eyeMap": fix.astype(np.float64)})
            fh.write(f"{v} {len(frames)} 30.0\n")
    return names


def _metric_host_ms(pred, gt, fix, other, base, reps: int = 5) -> dict:
    """ms per frame of each metric on the host for one map at 224 x 384."""
    from vinet_tpu_torch.metrics import (auc_borji, auc_judd, auc_shuffled, cc_score,
                                         info_gain, kldiv_score, nss_score, similarity_score)
    from vinet_tpu_torch.metrics.emd import emd_score

    calls = {"cc": lambda: cc_score(pred, gt), "sim": lambda: similarity_score(pred, gt),
             "nss": lambda: nss_score(pred, fix), "kldiv": lambda: kldiv_score(pred, gt),
             "aucj": lambda: auc_judd(pred, fix), "aucb": lambda: auc_borji(pred, fix),
             "sauc": lambda: auc_shuffled(pred, fix, other),
             "ig": lambda: info_gain(pred, fix, base), "emd": lambda: emd_score(pred, gt)}
    out = {}
    for name, call in calls.items():
        call()  # the first EMD call loads the native library
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        out[name] = (time.perf_counter() - t0) / reps * 1e3
    return out


def _maps_equal(torch, a, b) -> bool:
    """The bf16 maps of two models on one window batch, bit for bit."""
    from vinet_tpu_torch.data.pipeline import device_preprocess
    from vinet_tpu_torch.inference.engine import prepared_copy

    g = torch.Generator(device="cuda").manual_seed(7)
    x = device_preprocess(torch.randint(0, 256, (4, 32, 224, 384, 3), generator=g,
                                        device="cuda", dtype=torch.uint8)).to(torch.bfloat16)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.inference_mode():
            ma = prepared_copy(a, torch.bfloat16, "cuda")(x)
            mb = prepared_copy(b, torch.bfloat16, "cuda")(x)
        return bool(torch.equal(ma, mb))
    finally:
        torch.backends.cudnn.deterministic = det


def phase_accuracy(torch, ck_dir: str) -> dict:
    """Accuracy and evaluation on the card: the fixture suite and the blob
    video (parity against streaming, bf16 and f32) with the JAX tests'
    bounds; generate_result -> evaluate_dhf1k with every metric; diem_val
    against eval_diem on a STAViS-layout set; export_checkpoint from the
    fixture and from the train phase's checkpoint; the metrics' host cost.
    Each model-driven path runs with the launch counts at 0 and must launch
    the fused head."""
    import numpy as np

    from vinet_tpu_torch.cli.diem_val import main as diem_val_main
    from vinet_tpu_torch.cli.eval_diem import main as eval_diem_main
    from vinet_tpu_torch.cli.evaluate_dhf1k import main as evaluate_main
    from vinet_tpu_torch.cli.export_checkpoint import main as export_main
    from vinet_tpu_torch.cli.generate_result import main as generate_main
    from vinet_tpu_torch.data.synthetic import build_blob_dataset
    from vinet_tpu_torch.inference.accuracy import (evaluate_fixture_suite, evaluate_modes,
                                                    load_artifact)
    from vinet_tpu_torch.io.checkpoint import restore_raw
    from vinet_tpu_torch.io.images import load_map
    from vinet_tpu_torch.models import ViNet

    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    model = load_artifact(FIXTURE)
    paths, seconds = {}, {}

    def counted(name, fn):
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        paths[name] = _launch_counts()
        _require_head(paths[name], f"the accuracy path {name}")
        return out

    # (a) the fixture suite, bf16: 5 kinds x 72 frames, batch 16, chunk 128
    suite = counted("accuracy_fixture_suite", lambda: evaluate_fixture_suite(
        model, n_frames=72, dtype=torch.bfloat16, batch=16, chunk=128, device="cuda"))
    # (b) the blob video, stride 4, batch 8, in bf16 and f32
    modes = {name: counted(f"accuracy_blob_{name}", lambda dt=dt: evaluate_modes(
        model, n_frames=72, seeds=(100,), dtype=dt, parity_stride=4, batch=8, device="cuda"))
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    keys = ("parity_cc", "streaming_cc", "cc_delta", "agreement_cc")
    bf16_shift = {k: modes["bf16"][k] - modes["f32"][k] for k in keys}

    # (c) the CLIs on a DHF1K-layout set and its STAViS layout
    weights = ["--file_weight", FIXTURE, "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        _, val = build_blob_dataset(tmp, n_train=0, n_val=2, n_frames=72)
        n_eval = 2 * 72
        pred = os.path.join(tmp, "pred")
        counted("accuracy_generate_result", lambda: _run_cli(
            generate_main, ["--path_indata", val, "--save_path", pred, *weights]))
        lines, seconds["evaluate_dhf1k"] = _run_cli(evaluate_main, [
            "--pred_path", pred, "--gt_path", val, "--metrics", ",".join(ALL_METRICS)])
        dhf1k = _overall(lines, "=== overall (per-video means) ===")

        stavis = os.path.join(tmp, "stavis")
        names = _write_stavis(val, stavis)
        frames_in = os.path.join(tmp, "stavis_in")  # generate_result's <video>/images/
        for v in names:
            os.makedirs(os.path.join(frames_in, v))
            os.symlink(os.path.join(stavis, "video_frames", "DIEM", v),
                       os.path.join(frames_in, v, "images"))
        pred_jpg = os.path.join(tmp, "pred_jpg")
        counted("accuracy_generate_result_stavis", lambda: _run_cli(
            generate_main, ["--path_indata", frames_in, "--save_path", pred_jpg, *weights]))
        diem_lines, _ = counted("diem_val", lambda: _run_cli(diem_val_main, [
            "--path_data", stavis, "--dataset", "DIEM", "--mode", "test",
            "--use_sound", "False", *weights]))
        diem = {"per_frame": _overall(diem_lines, "=== per-frame averages ==="),
                "per_video": _overall(diem_lines, "=== per-video averages ===")}
        lines, seconds["eval_diem"] = _run_cli(eval_diem_main, [
            "--pred_path", pred_jpg, "--annot_path", os.path.join(stavis, "annotations", "DIEM"),
            "--annot_file", os.path.join(stavis, "fold_lists", "DIEM_list_test_fps.txt"),
            "--emd", "--per_frame"])
        eval_diem = _overall(lines, "=== overall ===")
        written = sorted(os.listdir(os.path.join(pred_jpg, names[0])))

        # (e) the metrics' host cost, one map at 224 x 384
        v0 = os.path.join(val, names[0])
        fix_dir = os.path.join(v0, "fixation")
        fixes = [load_map(os.path.join(fix_dir, f)) > 0 for f in sorted(os.listdir(fix_dir))]
        # 10 fixations (a frame has one, and AUC-Borji needs two), the shuffle
        # map of 10 other frames', the IG baseline of 10 GT maps
        fix = np.logical_or.reduce(fixes[:10]).astype(np.float64)
        other = np.logical_or.reduce(fixes[10:20]).astype(np.float64)
        base = np.mean([load_map(os.path.join(v0, "maps", "%04d.png" % f))
                        for f in range(2, 12)], axis=0)
        host_ms = _metric_host_ms(load_map(os.path.join(pred, names[0], "0001.png")),
                                  load_map(os.path.join(v0, "maps", "0001.png")), fix, other,
                                  base)

    # (d) export: the fixture and the train phase's checkpoint
    exports = {}
    ck_model = ViNet(3, 32)
    ck_model.load_state_dict(restore_raw(ck_dir)["model"], strict=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, source, src_model in (("fixture", ["--file_weight", FIXTURE], model),
                                        ("train_checkpoint", ["--checkpoint_dir", ck_dir],
                                         ck_model)):
            out = os.path.join(tmp, f"{name}.pt")
            _, secs = _run_cli(export_main, [*source, "--output", out])
            fresh = ViNet(3, 32)
            fresh.load_state_dict(torch.load(out, weights_only=True), strict=True)
            exports[name] = {"seconds": secs, "maps_equal": _maps_equal(torch, fresh, src_model)}
        try:  # a model built from other flags fails the strict load
            with contextlib.redirect_stderr(io.StringIO()):
                export_main(["--clip_size", "16", "--checkpoint_dir", ck_dir,
                             "--output", os.path.join(tmp, "x.pt")])
            mismatch_exit = 0
        except SystemExit as e:
            mismatch_exit = e.code

    rec = {"phase": "accuracy", "config": "ViNet(3,32) fixture weights, 224 x 384",
           "fixture_suite": {"dtype": "bfloat16", "frames": 72, "batch": 16, "chunk": 128,
                             **suite},
           "blob": {"frames": 72, "seeds": [100], "parity_stride": 4, "batch": 8, **modes},
           "bf16_minus_f32": bf16_shift,
           "evaluate_dhf1k": {"videos": 2, "frames": n_eval, "overall": dhf1k,
                              "frames_per_s": n_eval / seconds["evaluate_dhf1k"]},
           "diem_val": {**diem, "frames_per_s": n_eval / seconds["diem_val"]},
           "eval_diem_per_frame": eval_diem,
           "diem_cc_abs_diff": abs(diem["per_frame"]["cc"] - eval_diem["cc"]),
           "diem_cc_tol": DIEM_CC_TOL,
           "generate_result_maps_per_s": n_eval / seconds["accuracy_generate_result"],
           "metric_host_ms_per_frame": host_ms, "exports": exports,
           "export_flag_mismatch_exit": mismatch_exit, "seconds": seconds,
           "launches": paths, "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    for row in suite["fixtures"]:
        check(row["cc_delta"] >= KIND_DELTA_MIN and row["agreement_cc"] >= KIND_AGREEMENT_MIN,
              f"fixture suite bf16, kind {row}")
    check(suite["cc_delta_min"] >= SUITE_DELTA_MIN, f"cc_delta_min {suite['cc_delta_min']}")
    check(suite["cc_delta_mean"] >= SUITE_DELTA_MEAN_MIN, f"cc_delta_mean {suite['cc_delta_mean']}")
    for name, r in modes.items():
        for k, lo in MODES_MIN.items():
            check(r[k] > lo, f"blob {name}: {k} {r[k]} not above {lo}")
        for k, lo in MODES_AT_LEAST.items():
            check(r[k] >= lo, f"blob {name}: {k} {r[k]} below {lo}")
    check(sorted(dhf1k) == sorted(m for m in ALL_METRICS if m != "aucb"),
          f"evaluate_dhf1k printed {sorted(dhf1k)}")  # aucb: one fixation a frame, undefined
    check(all(np.isfinite(v) for v in dhf1k.values()), f"evaluate_dhf1k overall {dhf1k}")
    check(dhf1k["cc"] > 0.5, f"evaluate_dhf1k cc {dhf1k['cc']}")
    check(written == ["img_%05d.jpg" % f for f in range(1, 73)], "generate_result's JPEG maps")
    check(sorted(eval_diem) == ["aucj", "cc", "emd", "nss", "sauc", "sim"]
          and all(np.isfinite(v) for v in eval_diem.values()), f"eval_diem {eval_diem}")
    check(sorted(diem["per_frame"]) == ["aucj", "cc", "nss", "sim"], f"diem_val {diem}")
    check(rec["diem_cc_abs_diff"] <= DIEM_CC_TOL,
          f"diem_val cc {diem['per_frame']['cc']} vs eval_diem cc {eval_diem['cc']}")
    for name, e in exports.items():
        check(e["maps_equal"], f"the {name} export does not reproduce its model's maps")
    check(mismatch_exit == 2, f"export with mismatched flags exited {mismatch_exit}")
    return rec


# the audio-visual phase: AViNet(3, 32) at 224 x 384 with the fixture's
# visual weights and seeded audio and fusion weights
AV_SEED = 0
AV_FPS = 25.0
AV_FS = 22050
# AViNet's evaluate_av_agreement on the blob kind: bf16 against f32
AV_AGREEMENT_BF16_TOL = 0.005


def _av_model(torch, use_transformer: bool = False):
    """AViNet(3, 32) in f32 on the CPU, unprepared."""
    from vinet_tpu_torch.inference.accuracy import av_fixture_model

    return av_fixture_model(FIXTURE, seed=AV_SEED, use_transformer=use_transformer)


def _av_audio(torch, b: int, seed: int):
    """(b, 70560, 1) excerpts at the raw 2^-23 scale of a loud int16 wav."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, 70560, 1), generator=g, device="cuda") * (8000 * 2.0**-23)


def _write_av_videos(root: str, n_videos: int, n_frames: int, size: tuple) -> list:
    """A STAViS layout (video_frames/DIEM/<v>/img_%05d.jpg, a 22050 Hz int16
    wav video_audio/DIEM/<v>/<v>.wav, the DIEM test fold list), and the
    theatre layout of the same videos (theatre/fps.json,
    theatre/video_frames/<v>/, a 44100 Hz wav theatre/video_audio/<v>.wav).
    Returns the names."""
    import numpy as np
    from PIL import Image
    from scipy.io import wavfile

    rng = np.random.default_rng(5)
    names = ["v%02d" % v for v in range(n_videos)]
    os.makedirs(os.path.join(root, "fold_lists"))
    os.makedirs(os.path.join(root, "theatre", "video_audio"))
    for v in names:
        fdir = os.path.join(root, "video_frames", "DIEM", v)
        wdir = os.path.join(root, "video_audio", "DIEM", v)
        os.makedirs(fdir)
        os.makedirs(wdir)
        for f, img in enumerate(_video_frames(rng, n_frames, size), start=1):
            Image.fromarray(img).save(os.path.join(fdir, "img_%05d.jpg" % f), quality=95)
        for fs, path in ((AV_FS, os.path.join(wdir, f"{v}.wav")),
                         (44100, os.path.join(root, "theatre", "video_audio", f"{v}.wav"))):
            t = np.arange(int(fs * n_frames / AV_FPS)) / fs
            wav = 8000 * np.sin(2 * np.pi * (220 + 200 * t) * t) + rng.normal(0, 500, t.shape)
            wavfile.write(path, fs, wav.astype(np.int16))
        os.makedirs(os.path.join(root, "theatre", "video_frames"), exist_ok=True)
        os.symlink(fdir, os.path.join(root, "theatre", "video_frames", v))
    with open(os.path.join(root, "fold_lists", "DIEM_list_test_fps.txt"), "w") as fh:
        fh.writelines(f"{v} {n_frames} {AV_FPS}\n" for v in names)
    with open(os.path.join(root, "fps.json"), "w") as fh:
        json.dump({v: AV_FPS for v in names}, fh)
    with open(os.path.join(root, "theatre", "fps.json"), "w") as fh:
        json.dump({v: AV_FPS for v in names}, fh)
    return names


def phase_av(torch) -> dict:
    """AViNet on every serving path: the window batch (bf16 clips/s, the
    fusion's share of the device time, bf16 against f32, card against CPU,
    the refinement encoder once), the CLIs (generate_result_audio_visual
    parity, --streaming, --live; generate_result_dave; generate_theatre on a
    44.1 kHz wav), one --streaming chunk's device time by part, the
    multi-stream server against single streams, and evaluate_av_agreement. Each path runs with the launch counts at 0 and
    must launch the fused head. Returns the launches by path."""
    import numpy as np

    from vinet_tpu_torch.cli.generate_result import live_span
    from vinet_tpu_torch.cli.generate_result_audio_visual import main as av_main
    from vinet_tpu_torch.cli.generate_result_dave import main as dave_main
    from vinet_tpu_torch.cli.generate_theatre import main as theatre_main
    from vinet_tpu_torch.data.audio import audio_excerpt
    from vinet_tpu_torch.data.pipeline import device_preprocess
    from vinet_tpu_torch.inference import (AVLiveStreamingPredictor, AVMultiLiveServer,
                                           AVStreamingPredictor)
    from vinet_tpu_torch.inference.accuracy import evaluate_av_agreement, synthetic_audio_info
    from vinet_tpu_torch.inference.streaming import dense_decoder_front, streaming_pyramid
    from vinet_tpu_torch.io.export import export_torch_checkpoint
    from vinet_tpu_torch.models import cast_floating, fold_batchnorms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    paths, rec = {}, {"phase": "av", "config": "AViNet(3,32) bilinear, fixture visual weights, "
                      f"audio and fusion from numpy seed {AV_SEED}, BN folded"}

    def counted(name, fn):
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        paths[name] = _launch_counts()
        _require_head(paths[name], f"the AV path {name}")
        return out, time.perf_counter() - t0

    # (a) the window batch
    base = _av_model(torch)  # unfolded: the CLIs load its export strictly
    model = fold_batchnorms(copy.deepcopy(base).eval())
    cpu32 = cast_floating(copy.deepcopy(model), torch.float32)
    gpu32 = copy.deepcopy(cpu32).cuda()
    gpu16 = cast_floating(copy.deepcopy(model), torch.bfloat16).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = device_preprocess(torch.randint(0, 256, (16, 32, 224, 384, 3), generator=g,
                                        device="cuda", dtype=torch.uint8))
    audio = _av_audio(torch, 16, 1)
    x16, a16 = x.to(torch.bfloat16), audio.to(torch.bfloat16)
    with torch.inference_mode():
        out16, _ = counted("av_window_batch", lambda: gpu16(x16, a16).float())
        out32 = gpu32(x, audio)
        check(out16.shape == (16, 224, 384) and bool(torch.isfinite(out16).all()),
              "AV bf16 output")
        d = (out16 - out32).abs()
        bf16_max, bf16_mean = float(d.max()), float(d.mean())
        cpu_err = float((gpu32(x[:1], audio[:1]).cpu() - cpu32(x[:1].cpu(), audio[:1].cpu()))
                        .abs().max())
        del out32, gpu32
        iters = 5
        for _ in range(2):
            gpu16(x16, a16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            gpu16(x16, a16)
        torch.cuda.synchronize()
        clips_per_s = iters * 16 / (time.perf_counter() - t0)
        state = {}

        def backbone():
            state["pyr"] = gpu16.visual_model.backbone(x16.permute(0, 4, 1, 2, 3).contiguous())

        def fusion():
            state["fused"] = gpu16.fuse(state["pyr"][0], a16)

        def decoder():
            gpu16.visual_model.decoder([state["fused"], *state["pyr"][1:]])

        parts = [("backbone", backbone), ("soundnet_pool_bilinear", fusion), ("decoder", decoder)]
        _part_times(torch, parts)
        part_ms = _part_times(torch, parts)
        profile = profile_device(torch, lambda: gpu16(x16, a16))
        del gpu16, state
        torch.cuda.empty_cache()
        # the refinement encoder once, batch 2, bf16 against f32
        tr = fold_batchnorms(_av_model(torch, use_transformer=True).eval())
        tr16 = cast_floating(copy.deepcopy(tr), torch.bfloat16).cuda()
        tr32 = cast_floating(tr, torch.float32).cuda()
        tr_out, _ = counted("av_transformer", lambda: tr16(x16[:2], a16[:2]).float())
        tr_err = float((tr_out - tr32(x[:2], audio[:2])).abs().max())
        check(tr_out.shape == (2, 224, 384) and bool(torch.isfinite(tr_out).all()),
              "AV use_transformer output")
        del tr16, tr32, tr
    rec.update({
        "input": list(x.shape), "audio": list(audio.shape), "dtype": "torch.bfloat16",
        "bf16_clips_per_s": clips_per_s, "part_ms": part_ms,
        "fusion_share": part_ms["soundnet_pool_bilinear"] / sum(part_ms.values()),
        "profile": {k: profile[k] for k in ("device_ms", "device_idle_share", "kernel_ms",
                                            "top_kernels")},
        "bf16_vs_f32_max_abs_err": bf16_max, "bf16_vs_f32_mean_abs_err": bf16_mean,
        "bf16_tol": [BF16_MAX_TOL, BF16_MEAN_TOL], "card_f32_vs_cpu_f32_max_abs_err": cpu_err,
        "cpu_input": [1, 32, 224, 384, 3], "cpu_tol": CPU_TOL,
        "transformer_bf16_vs_f32_max_abs_err": tr_err})
    check(bf16_max <= BF16_MAX_TOL and bf16_mean <= BF16_MEAN_TOL,
          f"AV bf16 vs f32: max {bf16_max}, mean {bf16_mean}")
    check(cpu_err < CPU_TOL, f"AV card f32 vs CPU f32: max|err| {cpu_err}")
    check(tr_err <= BF16_MAX_TOL, f"AV use_transformer bf16 vs f32: max {tr_err}")
    check(profile["kernel_ms"]["saliency_head"] > 0, "the AV profile credits no time to the head")

    # (b) the CLIs on a synthetic STAViS layout, 2 videos x 72 frames
    n_videos, n_frames, size = 2, 72, (224, 384)
    clis = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        names = _write_av_videos(data, n_videos, n_frames, size)
        weights = os.path.join(tmp, "avinet.pt")
        export_torch_checkpoint(weights, base)
        common = ["--file_weight", weights, "--use_sound", "True", "--device", "cuda"]
        runs = {
            "av_parity": (av_main, ["--path_data", data, "--window_batch", "16"]),
            "av_streaming": (av_main, ["--path_data", data, "--streaming"]),
            "av_live": (av_main, ["--path_data", data, "--live", "--live_micro", "16"]),
            "av_dave": (dave_main, ["--path_data", data, "--fps_json",
                                    os.path.join(data, "fps.json")]),
            "av_theatre": (theatre_main, ["--path_indata", os.path.join(data, "theatre")]),
        }
        for name, (main, argv) in runs.items():
            out = os.path.join(tmp, name)
            (lines, _), seconds = counted(name, lambda: _run_cli(main, argv + common
                                                                 + ["--save_path", out]))
            for v in names:  # JPEG maps named as the frames
                written = sorted(os.listdir(os.path.join(out, v)))
                check(written == ["img_%05d.jpg" % f for f in range(1, n_frames + 1)],
                      f"{name} {v}: {len(written)} maps for {n_frames} frames")
            check(lines[-1] == f"wrote {n_videos * n_frames} maps", f"{name}: {lines[-1]}")
            clis[name] = {"seconds": seconds, "maps_per_s": n_videos * n_frames / seconds}
    rec["clis"] = {"videos": n_videos, "frames": n_frames, "frame_size": list(size), **clis}

    # (c) one 128-frame --streaming chunk's device time by part: its 97
    # window starts in 7 batches of 16, each with its excerpts (made before)
    pred = AVStreamingPredictor(base, chunk=128, batch=16, device="cuda")
    frames = torch.from_numpy(_video_frames(np.random.default_rng(1), 128, size)).cuda()[None]
    info = synthetic_audio_info(128, fps=AV_FPS, seed=1)
    batches = [list(range(lo, min(97, lo + 16))) for lo in range(0, 97, 16)]
    auds = [pred._audio([[audio_excerpt(info, 32, s) for s in b]]) for b in batches]
    with torch.inference_mode():
        state = {}

        def timeline():
            x = device_preprocess(frames).to(pred.dtype).permute(0, 4, 1, 2, 3).contiguous()
            state["tl"] = streaming_pyramid(pred.visual.backbone, x)

        def front():
            state["dense"] = dense_decoder_front(pred.visual.decoder, state["tl"],
                                                 with_conv1=False)

        def decode():
            state["maps"] = [pred._decode(state["tl"], state["dense"], pred._starts(b), a)[: len(b)]
                             for b, a in zip(batches, auds)]

        def post():
            for m in state["maps"]:
                pred._post(m, size, True).cpu()

        parts = [("timeline", timeline), ("dense_front", front), ("window_decode", decode),
                 ("post", post)]
        _part_times(torch, parts)
        chunk_ms = _part_times(torch, parts)
        chunk_profile = profile_device(torch, lambda: _part_times(torch, parts))
    del pred, state
    torch.cuda.empty_cache()
    rec["streaming_chunk"] = {"part_ms": chunk_ms,
                              "maps_per_s": 97 / sum(chunk_ms.values()) * 1e3,
                              "device_idle_share": chunk_profile["device_idle_share"],
                              "kernel_ms": chunk_profile["kernel_ms"],
                              "top_kernels": chunk_profile["top_kernels"][:6]}
    check(chunk_profile["kernel_ms"]["saliency_head"] > 0,
          "the AV chunk profile credits no time to the head")

    # (d) the multi-stream server: 4 streams x micro 32 against single streams (f32),
    # then its bf16 rate and one serve step's device time
    streams, micro, n = 4, 32, 96
    frames = np.stack([_video_frames(np.random.default_rng(20 + s), n, size)
                       for s in range(streams)])
    wavs = [np.random.default_rng(30 + s).normal(0, 0.001, int(AV_FS * n / AV_FPS))
            .astype(np.float32) for s in range(streams)]
    spf = AV_FS / AV_FPS
    cfg = dict(fps=AV_FPS, micro=micro, batch=micro, span=live_span(32, micro), device="cuda")

    def feed_all(pred, fr, ws):
        multi = fr.ndim == 5
        got = []
        for lo in range(0, n, micro):
            chunk = [w[int(lo * spf): int((lo + micro) * spf)] for w in ws]
            got += pred.feed(fr[:, lo:lo + micro] if multi else fr[lo:lo + micro],
                             audio=chunk if multi else chunk[0])
        got += pred.flush()
        return got

    multi32 = feed_all(AVMultiLiveServer(model, streams=streams, dtype=torch.float32, **cfg),
                       frames, wavs)
    multi_err = 0.0
    for s in range(streams):
        single = dict(feed_all(AVLiveStreamingPredictor(model, dtype=torch.float32, **cfg),
                               frames[s], [wavs[s]]))
        mine = [(i, m) for si, i, m in multi32 if si == s]
        check([i for i, _ in mine] == list(range(n)), f"multi-stream stream {s} frames")
        multi_err = max(multi_err, max(float(np.abs(m - single[i]).max()) for i, m in mine))
    server = AVMultiLiveServer(model, streams=streams, **cfg)
    feed_all(server, frames, wavs)  # warm-up: cuDNN picks its algorithms
    server.reset()
    got, seconds = counted("av_multi_live", lambda: feed_all(server, frames, wavs))
    check(len(got) == streams * n, f"av multi-stream emitted {len(got)} maps")
    for lo in range(0, 3 * micro, micro):  # refill the rolling buffers for the step's time
        list(server.feed(frames[:, lo:lo + micro],
                         audio=[w[int(lo * spf): int((lo + micro) * spf)] for w in wavs]))
    with torch.inference_mode():
        xs = torch.from_numpy(frames[:, :micro]).cuda()
        starts = server._starts(list(range(micro)))
        aud = server._audio([[np.zeros((70560, 1), np.float32)] * micro] * streams)
        step = [("advance", lambda: server._advance(xs)),
                ("window_decode", lambda: server._decode(*server._views(), starts, aud))]
        _part_times(torch, step)
        step_ms = _part_times(torch, step)
    rec["multi_stream"] = {
        "streams": streams, "micro": micro, "frames": n, "maps_per_s": streams * n / seconds,
        "step_part_ms": step_ms, "step_maps_per_s": streams * micro / sum(step_ms.values()) * 1e3,
        "f32_multi_vs_single_max_abs_err": multi_err, "tol": LIVE_MAX_TOL}
    check(multi_err < LIVE_MAX_TOL, f"AV multi-stream vs single streams: max {multi_err}")
    del server
    torch.cuda.empty_cache()

    # (e) streaming against parity agreement on the fixture suite
    suite, seconds = counted("av_agreement", lambda: evaluate_av_agreement(
        model, dtype=torch.bfloat16, batch=16, chunk=128, device="cuda"))
    blob32 = evaluate_av_agreement(model, kinds=("blob",), dtype=torch.float32, batch=16,
                                   chunk=128, device="cuda")
    shift = suite["fixtures"][0]["agreement_cc"] - blob32["agreement_min"]
    rec["agreement"] = {"bf16": suite, "blob_f32": blob32["agreement_min"],
                        "blob_bf16_minus_f32": shift, "tol": AV_AGREEMENT_BF16_TOL,
                        "seconds": seconds}
    check(suite["fixtures"][0]["kind"] == "blob" and abs(shift) <= AV_AGREEMENT_BF16_TOL,
          f"AV agreement on the blob kind: bf16 - f32 = {shift}")
    check(all(np.isfinite(r["agreement_cc"]) for r in suite["fixtures"]), f"AV agreement {suite}")
    rec.update({"launches": paths, "phase_seconds": time.perf_counter() - t_phase})
    emit(rec)
    print(f"av: agreement_min {suite['agreement_min']} agreement_mean {suite['agreement_mean']}",
          flush=True)
    return paths


# AV train step, card f32 against CPU f32 (AViNet(3, 32) at 2 x 32 x 64 x 96):
# the loss as ViNet's step holds it (TRAIN_CPU_LOSS_TOL), SoundNet's and the
# visual net's new running statistics within 1e-4 of each tensor's largest
# value (the batch statistics pass through momentum 0.1 and 0.001)
AV_TRAIN_CPU_STATS_TOL = 1e-4


def _write_av_sets(root: str, n_videos: int, n_frames: int, size: tuple) -> None:
    """The six audio-visual sets in the STAViS layout (tests/fixtures.py's
    make_sound_dataset): per set, videos with frames
    video_frames/<DS>/<v>/img_%05d.jpg, their blob as GT
    annotations/<DS>/<v>/maps/eyeMap_%05d.jpg, a 22050 Hz int16 wav
    video_audio/<DS>/<v>/<v>.wav, and the train and test fold lists (DIEM's
    without a split, the others' of split 1)."""
    import numpy as np
    from PIL import Image
    from scipy.io import wavfile

    from vinet_tpu_torch.data.datasets import AV_DATASETS

    rng = np.random.default_rng(9)
    os.makedirs(os.path.join(root, "fold_lists"))
    for ds in AV_DATASETS:
        names = [f"{ds.lower()}{v:02d}" for v in range(n_videos)]
        for v in names:
            fdir = os.path.join(root, "video_frames", ds, v)
            mdir = os.path.join(root, "annotations", ds, v, "maps")
            wdir = os.path.join(root, "video_audio", ds, v)
            for d in (fdir, mdir, wdir):
                os.makedirs(d)
            for f, img in enumerate(_video_frames(rng, n_frames, size)):
                Image.fromarray(img).save(os.path.join(fdir, "img_%05d.jpg" % (f + 1)),
                                          quality=95)
                gt = np.round(255.0 * _blob(size, f, n_frames)).astype(np.uint8)
                Image.fromarray(gt).save(os.path.join(mdir, "eyeMap_%05d.jpg" % (f + 1)),
                                         quality=100)
            t = np.arange(int(AV_FS * n_frames / AV_FPS)) / AV_FS
            wav = 8000 * np.sin(2 * np.pi * (220 + 200 * t) * t) + rng.normal(0, 500, t.shape)
            wavfile.write(os.path.join(wdir, f"{v}.wav"), AV_FS, wav.astype(np.int16))
        for mode in ("train", "test"):
            name = f"DIEM_list_{mode}_fps.txt" if ds == "DIEM" else f"{ds}_list_{mode}_1_fps.txt"
            with open(os.path.join(root, "fold_lists", name), "w") as fh:
                fh.writelines(f"{v} {n_frames} {AV_FPS}\n" for v in names)


def _av_batch(torch, b: int, h: int, w: int, seed: int) -> dict:
    batch = _train_batch(torch, b, 32, h, w, seed)
    batch["audio"] = _av_audio(torch, b, seed)
    return batch


def _timed_steps(torch, ts, step, batch, n_warm: int = 2, n_timed: int = 5) -> dict:
    """n_warm + n_timed steps: their losses, ms (each waits for its loss),
    the median of the timed ones, peak memory and the launch counts."""
    import numpy as np

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    losses, ms = [], []
    for _ in range(n_warm + n_timed):
        t0 = time.perf_counter()
        _, metrics = step(ts, batch)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "step_ms": ms, "step_ms_median": float(np.median(ms[n_warm:])),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": _launch_counts()}


def phase_av_train(torch, card: str) -> dict:
    """Audio-visual training on the card: AViNet(3, 32) at 224 x 384, batch
    8, bf16 (the bilinear fusion, then the refinement encoder), its eval
    step through the fused head, dropout on the card, card against CPU,
    AViNetFusion, and the train CLI on the six STAViS sets with validation,
    checkpoint and resume. Returns the launches by path."""
    import numpy as np

    from vinet_tpu_torch.inference.accuracy import av_fixture_model
    from vinet_tpu_torch.io.checkpoint import latest_step
    from vinet_tpu_torch.models.inference import make_inference_fn
    from vinet_tpu_torch.training import LossConfig
    from vinet_tpu_torch.training.trainer import (init_train_state, make_eval_step,
                                                  make_train_step)

    t_phase = time.perf_counter()
    cfg = LossConfig()
    paths, rec = {}, {"phase": "av_train", "card": card, "input": [8, 32, 224, 384, 3],
                      "audio": [8, 70560, 1], "precision": "bf16 convs, f32 masters, Adam 1e-4"}
    step16 = make_train_step(cfg, compute_dtype=torch.bfloat16)
    batch = _av_batch(torch, 8, 224, 384, seed=20)

    # (a) full-width bf16 steps: the bilinear fusion, then the refinement encoder
    for name, use_transformer in (("bilinear", False), ("encoder", True)):
        model = _av_model(torch, use_transformer).cuda()
        bn0 = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        ts = init_train_state(model, 1e-4)
        run = _timed_steps(torch, ts, step16, batch)
        moved = {part: sum(not torch.equal(v, bn0[k]) for k, v in model.state_dict().items()
                           if "running" in k and k.startswith("audionet.") == (part == "audio"))
                 for part in ("audio", "visual")}
        run.update(bn_stats_moved=moved, bn_stats=len(bn0),
                   grads_finite=all(bool(torch.isfinite(p.grad).all())
                                    for p in model.parameters() if p.grad is not None))
        paths[f"av_train_steps_{name}"] = run["launches"]
        check(all(np.isfinite(run["losses"])), f"AV {name} train losses {run['losses']}")
        check(run["grads_finite"], f"AV {name}: a gradient is not finite")
        check(moved["audio"] + moved["visual"] == len(bn0),
              f"AV {name}: BN statistics that did not move: {len(bn0)} - {moved}")
        check(all(v == 0 for v in run["launches"].values()),
              f"AV {name} train steps launched a kernel: {run['launches']}")
        if name == "bilinear":  # (b) the eval step on the trained model: the fused head
            run["profile"] = profile_device(torch, lambda: step16(ts, batch))
            _reset_launch_counts()
            metrics, pred = make_eval_step(cfg)(ts, batch)
            paths["av_train_eval_step"] = _launch_counts()
            _require_head(paths["av_train_eval_step"], "the AV eval step")
            run["eval_loss"] = float(metrics["loss"])
            check(pred.shape == (8, 224, 384) and bool(torch.isfinite(pred).all()),
                  f"AV eval step maps {tuple(pred.shape)}")
        rec[name] = run
        del model, ts
        torch.cuda.empty_cache()
    rec["encoder_minus_bilinear_ms"] = (rec["encoder"]["step_ms_median"]
                                        - rec["bilinear"]["step_ms_median"])

    # (c) dropout on the card (the encoder, batch 2, lr 0): the masks follow
    # the step, a state without a seed repeats, the same step repeats exactly
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = _av_model(torch, True).cuda()
        small = {k: v[:2] for k, v in batch.items()}
        step32 = make_train_step(cfg)

        def losses(seed, n):
            ts = init_train_state(copy.deepcopy(model), 0.0, seed=seed)
            return [float(step32(ts, small)[1]["loss"]) for _ in range(n)]

        drop, again, plain = losses(0, 2), losses(0, 1), losses(None, 2)
        rec["dropout"] = {"losses_seed0": drop, "repeat_step0": again, "losses_no_seed": plain}
        check(drop[0] != drop[1], f"dropout: steps 0 and 1 gave one loss {drop}")
        check(again[0] == drop[0], f"dropout: step 0 did not repeat: {again[0]} vs {drop[0]}")
        check(plain[0] == plain[1], f"no dropout seed, yet the losses moved: {plain}")
        del model
    finally:
        torch.backends.cudnn.deterministic = det
    torch.cuda.empty_cache()

    # (d) one f32 step at 2 x 32 x 64 x 96: card against CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small_model = av_fixture_model(FIXTURE, seed=AV_SEED, input_hw=(64, 96))
    sb = _av_batch(torch, 2, 64, 96, seed=21)
    runs = {}
    for dev in ("cpu", "cuda"):
        ts = init_train_state(copy.deepcopy(small_model).to(dev), 1e-4, seed=None)
        _, m = make_train_step(cfg)(ts, {k: v.to(dev) for k, v in sb.items()})
        runs[dev] = (float(m["loss"]), {k: v.double().cpu() for k, v in ts.model.state_dict().items()
                                        if "running" in k})
    loss_err = abs(runs["cuda"][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
    stats_err = max(float((runs["cuda"][1][k] - v).abs().max() / v.abs().max())
                    for k, v in runs["cpu"][1].items())
    rec["card_vs_cpu_f32"] = {"input": [2, 32, 64, 96, 3], "loss_rel_err": loss_err,
                              "bn_stats_rel_err": stats_err,
                              "tol": [TRAIN_CPU_LOSS_TOL, AV_TRAIN_CPU_STATS_TOL]}
    check(loss_err <= TRAIN_CPU_LOSS_TOL and stats_err <= AV_TRAIN_CPU_STATS_TOL,
          f"AV card vs CPU f32 step: loss {loss_err}, statistics {stats_err}")

    # (e) AViNetFusion: bf16 against f32 through make_inference_fn, one train step
    fusion = av_fixture_model(FIXTURE, seed=AV_SEED, fusion=True)
    clips, audio = batch["clip"][:2], batch["audio"][:2]
    maps = {}
    for dtype in ("float32", "bfloat16"):
        fn, _ = make_inference_fn(copy.deepcopy(fusion), dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        _reset_launch_counts()
        maps[dtype] = fn(clips, audio)
        torch.cuda.synchronize()
        paths[f"fusion_eval_{dtype}"] = _launch_counts()
        _require_head(paths[f"fusion_eval_{dtype}"], f"AViNetFusion's {dtype} forward")
    diff = (maps["bfloat16"] - maps["float32"]).abs()
    ts = init_train_state(fusion.cuda(), 1e-4)
    frun = _timed_steps(torch, ts, step16, {k: v[:2] for k, v in batch.items()}, 1, 2)
    paths["fusion_train_steps"] = frun["launches"]
    rec["fusion"] = {"config": "AViNetFusion(512), fixture visual weights", "input": [2, 32, 224,
                     384, 3], "bf16_vs_f32_max": float(diff.max()),
                     "bf16_vs_f32_mean": float(diff.mean()),
                     "tol": [BF16_MAX_TOL, BF16_MEAN_TOL], "train": frun}
    check(float(diff.max()) <= BF16_MAX_TOL and float(diff.mean()) <= BF16_MEAN_TOL,
          f"AViNetFusion bf16 vs f32: max {float(diff.max())}, mean {float(diff.mean())}")
    check(all(np.isfinite(frun["losses"])) and all(v == 0 for v in frun["launches"].values()),
          f"AViNetFusion train steps: {frun}")
    del fusion, ts, batch
    torch.cuda.empty_cache()

    # (f) the train CLI on the six STAViS sets: validation, checkpoint, resume
    clis = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, ck, best = (os.path.join(tmp, n) for n in ("stavis", "ck", "best.pt"))
        _write_av_sets(root, 3, 40, (112, 192))
        common = ["--dataset", "SoundDataset", "--split", "1", "--train_path_data", root,
                  "--use_sound", "True", "--use_transformer", "True", "--bf16",
                  "--batch_size", "8", "--max_steps_per_epoch", "2", "--no_epochs", "1",
                  "--no_workers", "8", "--checkpoint_dir", ck, "--model_val_path", best,
                  "--device", "cuda"]
        for name, extra in (("train", []), ("resume", ["--resume", "--bn_recal", "1"])):
            torch.cuda.synchronize()
            _reset_launch_counts()
            t0 = time.perf_counter()
            _cli_train(common + extra)
            clis[name] = {"seconds": time.perf_counter() - t0, "launches": _launch_counts(),
                          "latest_step": latest_step(ck)}
            paths[f"cli_av_train_{name}"] = clis[name]["launches"]
            _require_head(clis[name]["launches"], f"cli.train --use_sound {name}'s validation")
        saved = torch.load(best, weights_only=True)
    check(clis["train"]["latest_step"] == 2 and clis["resume"]["latest_step"] == 4,
          f"AV checkpoint steps {clis['train']['latest_step']}, {clis['resume']['latest_step']}")
    check("transformer.pos_encoder.pe" in saved and saved["audionet.conv1.weight"].dim() == 4,
          "the AV best model is not in the reference's layout")
    rec.update(cli=clis, launches=paths, phase_seconds=time.perf_counter() - t_phase)
    emit(rec)
    return paths


# phase tased: TASEDv2 in bf16 against f32 is held to the model phase's
# bounds (BF16_MAX_TOL, BF16_MEAN_TOL: some 70 convolutions, as ViNet's),
# card f32 against CPU f32 to CPU_TOL
TASED_BATCHES = (1, 8)


def _tased_model(torch, seed: int = 0):
    """TASEDv2 on the card: its S3D stages from the fixture (the trained S3D
    of ``artifacts/streamft_fixture.npz``, as the reference starts TASED from
    a trained S3D), its decoder from numpy seed: conv and ConvTranspose3d
    weights N(0, 1/fan_in), BatchNorm scale 1 + N(0, 0.01) and bias N(0,
    0.01), and the decoder's running statistics those of one seeded batch
    of 2 clips (momentum 1). A decoder of random weights over a random
    backbone amplifies bf16 rounding past any bound (on the CPU at 64 x 96
    the maps differ by up to 0.58); over the trained backbone it stays
    within ViNet's bounds (0.010-0.033 there)."""
    import numpy as np

    from vinet_tpu_torch.data.pipeline import device_preprocess
    from vinet_tpu_torch.io.weights import TASED_TRANSPOSED, load_weights
    from vinet_tpu_torch.models import TASEDv2
    from vinet_tpu_torch.ops.norm import override_momentum

    model = TASEDv2()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            holder, leaf = name.rsplit(".", 1)
            if not name.startswith("convtsp") or leaf == "num_batches_tracked":
                continue
            if t.dim() >= 2:  # a conv's (O, I, k...) or a ConvTranspose3d's (I, O, k...)
                fan_in = t.numel() // t.shape[1 if holder in TASED_TRANSPOSED else 0]
                v = rng.standard_normal(t.shape) / np.sqrt(fan_in)
            else:
                v = rng.standard_normal(t.shape) * 0.1 + (1.0 if leaf == "weight" else 0.0)
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    backbone = {k[len("backbone."):]: v for k, v in load_weights(FIXTURE).items()
                if k.startswith("backbone.")}
    missing = model.load_state_dict(backbone, strict=False).missing_keys
    check(all(k.startswith("convtsp") for k in missing), f"TASEDv2 backbone: {missing[:3]}")
    model = model.cuda().train()
    for name in ("base1", "base2", "base3", "base4"):
        getattr(model, name).eval()
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = device_preprocess(torch.randint(0, 256, (2, 32, 224, 384, 3), generator=g,
                                        device="cuda", dtype=torch.uint8))
    with torch.no_grad(), override_momentum(model, 1.0):
        model(x)
    return model.eval()


def _transposed_convs(torch, model, x) -> dict:
    """Each ConvTranspose3d of model alone on the input that one forward of x
    (bf16 autocast) hands it: its input and weight shapes, FLOP count, its
    device ms by CUDA events (``ms``), the kernels cuDNN runs by
    torch.profiler, and its bound."""
    from torch.utils.flop_counter import FlopCounterMode

    from vinet_tpu_torch.tools.timing import cuda_ms

    inputs = {}
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: inputs.__setitem__(n, i[0]))
             for n, m in model.named_modules() if isinstance(m, torch.nn.ConvTranspose3d)]
    try:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            model(x)
    finally:
        for h in hooks:
            h.remove()
    out = {}
    modules = dict(model.named_modules())
    with torch.autocast("cuda", dtype=torch.bfloat16):
        for name, xi in inputs.items():
            ct = modules[name]
            ct(xi)  # warm: cuDNN picks its algorithm
            with FlopCounterMode(display=False) as flops:
                y = ct(xi)
            prof = profile_device(torch, lambda: ct(xi))
            moved = xi.numel() * xi.element_size() + ct.weight.numel() * 2 + \
                y.numel() * y.element_size()
            bound_ms, bound_by = bound(moved, flops.get_total_flops(), torch.bfloat16)
            out[name] = {"input": list(xi.shape), "weight": list(ct.weight.shape),
                         "output": list(y.shape), "flop": flops.get_total_flops(),
                         "ms": cuda_ms(lambda: ct(xi), 20),
                         "profiled_device_ms": prof["device_ms"], "bound_ms": bound_ms,
                         "bound_by": bound_by, "kernels": prof["top_kernels"][:4]}
    return out


def phase_tased(torch, card: str) -> dict:
    """Phase 16: TASEDv2 at full width on (B, 32, 224, 384, 3), B 1 and 8, in
    bf16 autocast over f32 weights (``_tased_model``: the fixture's S3D, a
    decoder seeded from numpy): the maps' shape and range, bf16 against f32
    at B 1, card f32 against CPU f32 at 32 x 32, forward ms, clips/s and
    peak memory at each B, the profile of one B 8 forward and each
    ConvTranspose3d alone (cuDNN's kernels, their time and bound). It
    launches no kernel of the repo. Returns its launch counts."""
    import numpy as np

    from vinet_tpu_torch.data.pipeline import device_preprocess

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(16)

    def clips(b, h=224, w=384):
        return device_preprocess(torch.randint(0, 256, (b, 32, h, w, 3), generator=g,
                                               device="cuda", dtype=torch.uint8))

    model = _tased_model(torch)
    bf16 = torch.autocast("cuda", dtype=torch.bfloat16)
    rec = {"phase": "tased", "card": card,
           "config": "TASEDv2: fixture S3D, decoder numpy seed 0 (its BatchNorm statistics "
                     "from 2 seeded clips), bf16 autocast over f32 weights"}
    _reset_launch_counts()
    with torch.inference_mode():
        x = clips(1)
        with bf16:
            y16 = model(x).float()
        y32 = model(x)
        torch.cuda.synchronize()
        d = (y16 - y32).abs()
        rec["maps"] = {"shape": list(y16.shape), "min": float(y16.min()),
                       "max": float(y16.max()), "std_f32": float(y32.std()),
                       "finite": bool(torch.isfinite(y16).all())}
        rec["bf16_vs_f32"] = {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
                              "tol": [BF16_MAX_TOL, BF16_MEAN_TOL]}
        small = clips(1, 32, 32)
        cpu = copy.deepcopy(model).cpu()
        rec["card_f32_vs_cpu_f32"] = {"input": [1, 32, 32, 32, 3], "tol": CPU_TOL,
                                      "max_abs_err": float((model(small).cpu()
                                                            - cpu(small.cpu())).abs().max())}
        del cpu, y16, y32
        for b in TASED_BATCHES:
            xb = clips(b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(7):  # 2 warm-up forwards, then 5 timed
                t0 = time.perf_counter()
                with bf16:
                    model(xb)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            med = float(np.median(ms[2:]))
            rec[f"batch_{b}"] = {"input": list(xb.shape), "forward_ms": ms,
                                 "forward_ms_median": med, "clips_per_s": b * 1e3 / med,
                                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as flops, bf16:
            model(xb)
        rec["flop_per_clip"] = flops.get_total_flops() / xb.shape[0]

        def forward():
            with bf16:
                model(xb)

        rec["profile_batch_8"] = profile_device(torch, forward)
        rec["transposed_convs_batch_8"] = _transposed_convs(torch, model, xb)
    launches = _launch_counts()
    rec.update(launches=launches, phase_seconds=time.perf_counter() - t_phase)
    emit(rec)
    m = rec["maps"]
    check(m["shape"] == [1, 224, 384] and m["finite"] and 0.0 <= m["min"] <= m["max"] <= 1.0,
          f"TASEDv2 maps: {m}")
    check(m["std_f32"] > 1e-3, f"TASEDv2's maps are flat: {m}")
    e = rec["bf16_vs_f32"]
    check(e["max_abs_err"] <= BF16_MAX_TOL and e["mean_abs_err"] <= BF16_MEAN_TOL,
          f"TASEDv2 bf16 vs f32: {e}")
    check(rec["card_f32_vs_cpu_f32"]["max_abs_err"] < CPU_TOL,
          f"TASEDv2 card vs CPU: {rec['card_f32_vs_cpu_f32']}")
    check(all(v == 0 for v in launches.values()), f"TASEDv2 launched a kernel: {launches}")
    return launches


# phase parallel: the synced-BatchNorm f32 step's loss against the unsharded
# step's, relative: the same math, BatchNorm in two passes against cuDNN's
PARALLEL_LOSS_TOL = 1e-5
# streaming_pyramid_tsharded at world 1 against streaming_pyramid, f32: the
# interior bound and the edge bound of tests/test_streaming.py:140-147, whose
# edge exclusion is max(56 // f // 8, 4) timeline positions at level rate f
TSHARD_RTOL = TSHARD_ATOL = 1e-4
TSHARD_EDGE_TOL = 0.1


def _tsharded_errs(ref, got) -> dict:
    """{level: (interior violation of |g - r| <= atol + rtol |r|, edge max
    |g - r|)} of the four timelines."""
    out = {}
    for name, r, g, f in zip(("y0", "y1", "y2", "y3"), ref, got, (8, 4, 2, 2)):
        e = max(56 // f // 8, 4)
        d = (g - r).abs()
        inner = (d - TSHARD_ATOL - TSHARD_RTOL * r.abs())[:, :, e:-e]
        out[name] = (float(inner.max()), float(d.max()))
    return out


def _same_files(a: str, b: str) -> tuple:
    """(files under a, how many differ from b's byte for byte or are missing)."""
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    bad = 0
    for n in names:
        with open(os.path.join(a, n), "rb") as fa:
            other = os.path.join(b, n)
            if not os.path.exists(other):
                bad += 1
                continue
            with open(other, "rb") as fb:
                bad += fa.read() != fb.read()
    return len(names), bad


def _parallel_rank(kept: str, result: str, port: int) -> None:
    """Phase parallel's one rank, in a child process: a world of 1 over
    NCCL (the VINET_* bring-up), its checks, its record as JSON in result."""
    os.environ.update(VINET_COORDINATOR=f"localhost:{port}", VINET_NUM_PROCESSES="1",
                      VINET_PROCESS_ID="0")
    import torch
    import torch.distributed as dist

    from vinet_tpu_torch.utils.runtime import init_distributed

    init_distributed("cuda")
    try:
        rec = _parallel_checks(torch, kept)
        with open(result, "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _parallel_checks(torch, kept: str) -> dict:
    import numpy as np
    import torch.distributed as dist

    from vinet_tpu_torch.cli.generate_result import main as generate_main
    from vinet_tpu_torch.cli.serve import main as serve_main
    from vinet_tpu_torch.cli.train import main as train_main
    from vinet_tpu_torch.inference import SlidingWindowPredictor
    from vinet_tpu_torch.inference.streaming import streaming_pyramid, streaming_pyramid_tsharded
    from vinet_tpu_torch.io.checkpoint import latest_step
    from vinet_tpu_torch.io.images import load_frame
    from vinet_tpu_torch.models import ViNet
    from vinet_tpu_torch.ops.norm import SyncBatchNorm, batchnorms
    from vinet_tpu_torch.parallel import Mesh, create_mesh
    from vinet_tpu_torch.training import LossConfig
    from vinet_tpu_torch.training.trainer import init_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False  # as the parent's phases since phase model
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh()
    rec = {"backend": dist.get_backend(), "world": dist.get_world_size(), "mesh": mesh.shape}
    launches = {}

    # 1. the parity predictor with mesh= against without, phase cli's first video
    frame_dir = os.path.join(kept, "cli", "data", "001", "images")
    frames = np.stack([load_frame(os.path.join(frame_dir, f), size=(224, 384))[0]
                       for f in sorted(os.listdir(frame_dir))])
    plain = dict(SlidingWindowPredictor(_fixture_vinet(), device="cuda").predict_video(frames))
    torch.cuda.synchronize()
    _reset_launch_counts()
    sharded = dict(SlidingWindowPredictor(_fixture_vinet(), device="cuda", mesh=mesh)
                   .predict_video(frames))
    launches["parallel_parity"] = _launch_counts()
    rec["parity"] = {"frames": len(frames), "maps_equal": sorted(sharded) == sorted(plain) and all(
        np.array_equal(sharded[i], plain[i]) for i in plain)}

    # 2. generate_result --data_parallel against phase cli's PNGs
    out = os.path.join(kept, "parallel_generate")
    _reset_launch_counts()
    _, seconds = _run_cli(generate_main, ["--path_indata", os.path.join(kept, "cli", "data"),
                                          "--save_path", out, "--file_weight", FIXTURE,
                                          "--device", "cuda", "--data_parallel"])
    launches["parallel_generate_result"] = _launch_counts()
    n, bad = _same_files(os.path.join(kept, "cli", "out"), out)
    rec["generate_result"] = {"pngs": n, "pngs_differing": bad, "seconds": seconds}

    # 3. the synced-BatchNorm train step: a mesh whose data group is the
    # world of 1 runs SyncBatchNorm and the gradient all-reduce over NCCL
    synced = Mesh({"data": 1, "model": 1}, (0, 0), {"data": dist.group.WORLD, "model": None})
    batch = _train_batch(torch, 8, 32, 224, 384, seed=0)
    f32 = {}
    for name, m in (("unsharded", None), ("synced", synced)):
        ts = init_train_state(_fixture_vinet().cuda(), 1e-4, mesh=m)
        _, metrics = make_train_step(LossConfig(), mesh=m)(ts, batch)
        f32[name] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
        if m is not None:
            bns = batchnorms(ts.model).values()
            f32["sync_batchnorms"] = [sum(isinstance(b, SyncBatchNorm) for b in bns), len(bns)]
        del ts
        torch.cuda.empty_cache()
    f32["loss_rel_err"] = abs(f32["synced"]["loss"] - f32["unsharded"]["loss"]) / abs(
        f32["unsharded"]["loss"])
    bf16 = {}
    for name, m in (("unsharded", None), ("synced", synced)):  # the same run, in turn
        ts = init_train_state(_fixture_vinet().cuda(), 1e-4, mesh=m)
        step = make_train_step(LossConfig(), compute_dtype=torch.bfloat16, mesh=m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(7):  # 2 warm-up steps, then 5 timed
            t0 = time.perf_counter()
            _, metrics = step(ts, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        bf16[name] = {"losses": losses, "step_ms": step_ms,
                      "step_ms_median": float(np.median(step_ms[2:])),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "step_launches": _launch_counts()}
        del ts, step
        torch.cuda.empty_cache()
    rec["train_step"] = {"f32": f32, "bf16": bf16, "tol": PARALLEL_LOSS_TOL}
    del batch

    # 4. train --multihost (world 1): validation through the head, rank 0's
    # checkpoint, --resume
    clis = {}
    root = os.path.join(kept, "parallel_train")
    train_dir, val_dir = os.path.join(root, "train"), os.path.join(root, "val")
    ck, best = os.path.join(root, "ck"), os.path.join(root, "best.pt")
    _write_videos(train_dir, 16, 40, (112, 192), maps=True)
    _write_videos(val_dir, 1, 40, (180, 320), maps=True)
    common = ["--train_path_data", train_dir, "--val_path_data", val_dir, "--multihost",
              "--bf16", "--batch_size", "8", "--max_steps_per_epoch", "2", "--no_epochs", "1",
              "--no_workers", "8", "--device", "cuda", "--load_weight", FIXTURE,
              "--checkpoint_dir", ck, "--model_val_path", best]
    for name, extra in (("train", []), ("resume", ["--resume"])):
        torch.cuda.synchronize()
        _reset_launch_counts()
        lines, seconds = _run_cli(train_main, common + extra)
        launches[f"parallel_cli_train_{name}"] = _launch_counts()
        clis[name] = {"seconds": seconds, "latest_step": latest_step(ck),
                      "resumed": any("resumed from step 2" in ln for ln in lines),
                      "val": [ln for ln in lines if "val] avg_loss" in ln]}
    rec["cli_train"] = {**clis, "best_written": os.path.exists(best)}

    # 5. serve --stream_parallel against phase serve's PNGs
    out = os.path.join(kept, "parallel_serve")
    _reset_launch_counts()
    _, seconds = _run_cli(serve_main, ["--path_indata", os.path.join(kept, "serve", "data"),
                                       "--save_path", out, "--streams", "4", "--live_micro",
                                       "32", "--file_weight", FIXTURE, "--device", "cuda",
                                       "--stream_parallel"])
    launches["parallel_serve"] = _launch_counts()
    n, bad = _same_files(os.path.join(kept, "serve", "out"), out)
    rec["serve"] = {"pngs": n, "pngs_differing": bad, "seconds": seconds}

    # 6. streaming_pyramid_tsharded on a 128-frame chunk against
    # streaming_pyramid, f32, on a seeded init as the JAX test's; the
    # fixture's trained weights reported beside it (their zero input frames
    # and the per-layer zero padding part further at the chunk's edges)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((1, 3, 128, 224, 384), generator=g, device="cuda")
    rec["tsharded"] = {"frames": 128, "tol": [TSHARD_RTOL, TSHARD_ATOL, TSHARD_EDGE_TOL]}
    for name in ("seeded", "fixture"):
        if name == "seeded":
            torch.manual_seed(0)
            backbone = ViNet(3, 32).cuda().eval().backbone
        else:
            backbone = _fixture_vinet().cuda().eval().backbone
        with torch.no_grad():
            rec["tsharded"][name] = _tsharded_errs(
                streaming_pyramid(backbone, x), streaming_pyramid_tsharded(backbone, x, mesh))
        del backbone
        torch.cuda.empty_cache()
    rec["launches"] = launches
    return rec


def phase_parallel(torch, card: str, kept: str, train: dict) -> dict:
    """Phase 15: the parallel paths as one NCCL rank (world 1) in a child
    process, whose process group ends with it; returns the head's launches
    on each path."""
    import multiprocessing

    import numpy as np

    t_phase = time.perf_counter()
    result = os.path.join(kept, "parallel.json")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    child = multiprocessing.get_context("spawn").Process(
        target=_parallel_rank, args=(kept, result, port))
    child.start()
    child.join(600)
    if child.is_alive():
        child.kill()
        child.join()
    check(child.exitcode == 0, f"the parallel rank exited with {child.exitcode}")
    with open(result) as f:
        rec = json.load(f)
    rec.update(phase="parallel", card=card, phase_seconds=time.perf_counter() - t_phase,
               phase_train_bf16_step_ms_median=train["step_ms_median"],
               phase_train_peak_mem_gb=train["peak_mem_gb"])
    emit(rec)
    launches = rec["launches"]
    check(rec["backend"] == "nccl" and rec["world"] == 1, f"world {rec['world']}, {rec['backend']}")
    check(rec["parity"]["maps_equal"], "the parity predictor's maps differ with mesh=")
    check(rec["generate_result"]["pngs"] > 0 and rec["generate_result"]["pngs_differing"] == 0,
          f"generate_result --data_parallel: {rec['generate_result']}")
    step = rec["train_step"]
    check(step["f32"]["loss_rel_err"] <= PARALLEL_LOSS_TOL,
          f"synced-BatchNorm f32 loss: {step['f32']}")
    n_sync, n_bn = step["f32"]["sync_batchnorms"]
    check(n_sync == n_bn > 0, f"{n_sync} of {n_bn} BatchNorms synced")
    for name, run in step["bf16"].items():
        check(all(np.isfinite(run["losses"])) and run["losses"][-1] < run["losses"][0]
              and run["step_launches"]["saliency_head"] == 0,
              f"bf16 {name} steps: {run['losses']}, launches {run['step_launches']}")
    cli = rec["cli_train"]
    check(cli["best_written"] and cli["train"]["latest_step"] == 2
          and cli["resume"]["latest_step"] == 4 and cli["resume"]["resumed"],
          f"train --multihost: {cli}")
    check(rec["serve"]["pngs"] > 0 and rec["serve"]["pngs_differing"] == 0,
          f"serve --stream_parallel: {rec['serve']}")
    for level, (inner, edge) in rec["tsharded"]["seeded"].items():
        check(inner <= 0 and edge <= TSHARD_EDGE_TOL, f"tsharded {level}: {inner}, {edge}")
    for path in ("parallel_parity", "parallel_generate_result", "parallel_cli_train_train",
                 "parallel_cli_train_resume", "parallel_serve"):
        _require_head(launches[path], path)
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
    card = phase_card()
    phase_build()
    rows = {"saliency_head": phase_head_kernel(torch), **phase_gemm_kernels(torch)}
    torch.cuda.empty_cache()
    phase_model(torch)
    int8_launches = phase_int8_model(torch)
    kept = tempfile.TemporaryDirectory()  # phase cli's and phase serve's files, for parallel
    cli_launches = phase_cli(torch, os.path.join(kept.name, "cli"))
    paths = {"cli": cli_launches}
    for name, phase in (("phasefold_tail", phase_phasefold), ("streaming", phase_streaming),
                        ("live", phase_live),
                        ("serve", lambda t: phase_serve(t, os.path.join(kept.name, "serve")))):
        paths[name] = phase(torch)["launches"]
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        ck_dir = os.path.join(work, "train_checkpoints")
        train = phase_train(torch, card, ck_dir)
        paths.update({"train_steps": train["step_launches"],
                      "train_eval_step": train["eval_launches"],
                      **{f"cli_train_{k}": v["launches"] for k, v in train["cli"].items()}})
        torch.cuda.empty_cache()
        paths.update(phase_accuracy(torch, ck_dir)["launches"])
    torch.cuda.empty_cache()
    paths.update(phase_av(torch))
    torch.cuda.empty_cache()
    paths.update(phase_av_train(torch, card))
    torch.cuda.empty_cache()
    paths["tased"] = phase_tased(torch, card)
    torch.cuda.empty_cache()
    with kept:
        paths.update(phase_parallel(torch, card, kept.name, train))
    # launches: the head's on the CLI (bf16 main path), the GEMM kernels' on
    # the int8 path; each path was read with the counts set to 0 before it
    for name, row in rows.items():
        row["launches"] = (cli_launches if name == "saliency_head" else int8_launches)[name]
    rows["saliency_head"]["launches_up2x"] = cli_launches["saliency_head_up2x"]
    rows["saliency_head"]["launches_by_path"] = {p: c["saliency_head_up2x"]
                                                 for p, c in paths.items()}
    emit({"kernels": [rows[name] for name in KERNELS]})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
