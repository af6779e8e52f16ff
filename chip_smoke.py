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
   just before and read just after.

Then one line lists every kernel with its numbers, and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import os
import re
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


def profile_window_batch(torch, model, x) -> dict:
    """The model's FLOP count (PyTorch's operators; the hand-written kernels'
    operations are not in it) and where the device time of one window batch
    goes, by kernel, from torch.profiler. ``kernel_ms`` sums the device time
    of each hand-written kernel (int8_mm's and tconv's instances of the
    shared GEMM core by their A loaders, Int8MmA and TconvA);
    ``upsample_trilinear3d_launches`` counts the decoder's upsamples."""
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
            "upsample_trilinear3d_launches": sum(n for k, _, n in kernels
                                                 if "upsample_trilinear3d" in k),
            "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "kernel_ms": {name: sum(ms for k, ms, _ in kernels if marker in k)
                          for name, marker in (("saliency_head", "saliency_head"),
                                               ("int8_mm", "Int8MmA"), ("tconv", "TconvA"))},
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
    check(profile["upsample_trilinear3d_launches"] == 4,
          f"{profile['upsample_trilinear3d_launches']} upsample launches in the bf16 window "
          "batch, expected 4 (the last is fused into the head)")


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
    check(launches["saliency_head_up2x"] > 0,
          "the fused head kernel was not launched on the main path")
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
    rows = {"saliency_head": phase_head_kernel(torch), **phase_gemm_kernels(torch)}
    torch.cuda.empty_cache()
    phase_model(torch)
    int8_launches = phase_int8_model(torch)
    cli_launches = phase_cli(torch)
    # launches: the head's on the CLI (bf16 main path), the GEMM kernels' on
    # the int8 path; each path was read with the counts set to 0 before it
    for name, row in rows.items():
        row["launches"] = (cli_launches if name == "saliency_head" else int8_launches)[name]
    rows["saliency_head"]["launches_up2x"] = cli_launches["saliency_head_up2x"]
    emit({"kernels": [rows[name] for name in KERNELS]})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
