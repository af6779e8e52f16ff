"""Time the int8 GEMM kernels (``int8_mm``, ``tconv``) at other tilings of
their shared core on one CUDA card.

Run from the root of a checkout: ``python -m vinet_tpu_torch.tools.sweep_gemm
[--out FILE]``. It builds ``csrc/int8_mm.cu`` and ``csrc/tconv.cu`` once per
tiling (``GEMM_ROW_BYTES``, ``GEMM_STAGES``, ``GEMM_MAX_BN``: see
``csrc/gemm_core.cuh``), one ``nvcc`` per library, all at once, into
``vinet_tpu_torch/_build/sweep/``. At each of the model's int8 shapes, with B
K-major as the model passes it, it holds every tiling's result against the
package's own build (exactly) and times it with ``tools.timing.cuda_ms``.
It prints the card's name and power limit, one JSON line per (shape,
tiling), and one line per shape with the fastest tiling beside the
package's; ``--out`` writes the same lines to a file.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import json
import os
import re
import subprocess
import sys

import torch

from vinet_tpu_torch.ops import build, int8_mm, tconv
from vinet_tpu_torch.tools.timing import cuda_ms

DEFAULT = (64, 4, 128)  # the package's tiling: row bytes a K step, stages, widest tile
TILINGS = list(itertools.product((32, 64, 128), (3, 4, 5), (128, 64)))
SWEEP_DIR = build.BUILD_DIR / "sweep"
ARGTYPES = {"int8_mm": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            "tconv": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]}

# (name, kernel, shapes, stride) at batch 16 of clip-32 windows at 224 x 384:
# int8_mm a (M, K) @ b (K, N); tconv the T-major slab x (T_pad, M, C) and w
# (kt, C, CO)
SHAPES = [
    ("experiment_4096x1024x1024", "int8_mm", [(4096, 1024), (1024, 1024)], None),
    # Mixed-3b branch 2 1x1x1, 192 -> 16 at (16, 28, 48) x T 16
    ("mixed3b_1x1x1_n16", "int8_mm", [(344064, 192), (192, 16)], None),
    # Mixed-4b branch 0 1x1x1, 480 -> 192 at T 8, 14 x 24
    ("mixed4b_1x1x1", "int8_mm", [(43008, 480), (480, 192)], None),
    # decoder conv4 (5,3,3) s5 im2col: (16, 192, 20, 56, 96) -> 64
    ("decoder_conv4_im2col", "int8_mm", [(344064, 8640), (8640, 64)], None),
    # the stem conv_s (1,7,7) s2 im2col, K 147 padded to 160
    ("stem_conv_s_im2col", "int8_mm", [(11010048, 160), (160, 64)], None),
    # the stem conv_t (7,1,1) s2, 64 channels at 112 x 192
    ("stem_conv_t", "tconv", [(38, 344064, 64), (7, 64, 64)], 2),
    # Mixed-4b branch 1 conv_t (3,1,1), 208 channels at T 8, 14 x 24
    ("mixed4b_conv_t_208", "tconv", [(10, 5376, 208), (3, 208, 208)], 1),
    # Mixed-5c branch 1 conv_t (3,1,1), 384 channels at T 4, 7 x 12
    ("mixed5c_conv_t_384", "tconv", [(6, 1344, 384), (3, 384, 384)], 1),
]


def _build(name: str, tiling) -> tuple:
    """Compile csrc/<name>.cu at tiling; return (library, ptxas spill bytes)."""
    row_bytes, stages, max_bn = tiling
    so = SWEEP_DIR / f"lib{name}-r{row_bytes}-s{stages}-n{max_bn}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, f"-DGEMM_ROW_BYTES={row_bytes}",
           f"-DGEMM_STAGES={stages}", f"-DGEMM_MAX_BN={max_bn}", "-o", str(so),
           str(build.CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {so.name}:\n{res.stdout}{res.stderr}")
    return so, sum(int(n) for n in re.findall(r"(\d+) bytes spill", res.stdout + res.stderr))


def _operands(kernel, shapes, stride, seed):
    """Seeded int8 operands on the card, B K-major: (a, bt) or (x, wt, stride)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a, b = (torch.randint(-127, 128, s, generator=g, device="cuda", dtype=torch.int8)
            for s in shapes)
    return (a, int8_mm.k_major(b)) if kernel == "int8_mm" else (a, int8_mm.k_major(b), stride)


def _reference(kernel, ops):
    """The package's own build on the same operands (B passed as its view)."""
    if kernel == "int8_mm":
        a, bt = ops
        return int8_mm.int8_mm_cuda(a, bt.t())
    x, wt, stride = ops
    return tconv.tconv_cuda(x, wt.permute(1, 2, 0), stride)


def _launcher(lib, kernel, ops):
    """(output, call): call launches the library's int8 entry into output."""
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "int8_mm":
        a, bt = ops
        (m, k), n = a.shape, bt.shape[0]
        out = torch.empty((m, n), dtype=torch.int32, device="cuda")
        fn = lib.int8_mm_s8
        args = (a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k, stream)
    else:
        x, wt, stride = ops
        (t_pad, m, c), (co, kt, _) = x.shape, wt.shape
        t_out = (t_pad - kt) // stride + 1
        out = torch.empty((t_out, m, co), dtype=torch.int32, device="cuda")
        fn = lib.tconv_s8
        args = (x.data_ptr(), wt.data_ptr(), out.data_ptr(), t_out, m, c, kt, co, stride, stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")

    return out, call


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_gemm: CUDA is not available; this sweep needs a card", file=sys.stderr)
        return 1
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    emit({"card": smi.strip().splitlines()[0]})
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(name, t) for name in ARGTYPES for t in TILINGS]
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        defaults = [pool.submit(build.build, name) for name in ARGTYPES]  # the package's own
        built = dict(zip(jobs, pool.map(lambda job: _build(*job), jobs)))
        for f in defaults:
            f.result()
    libs = {}
    for (name, tiling), (so, spills) in built.items():
        lib = ctypes.CDLL(str(so))
        for fn in (getattr(lib, f"{name}_s8"), getattr(lib, f"{name}_bf16")):
            fn.argtypes, fn.restype = ARGTYPES[name], ctypes.c_int
        libs[name, tiling] = lib
        if spills:
            emit({"kernel": name, "tiling": tiling, "spill_bytes": spills})

    for seed, (case, kernel, shapes, stride) in enumerate(SHAPES):
        ops = _operands(kernel, shapes, stride, seed)
        want = _reference(kernel, ops)
        ops_count = 2 * want.numel() * shapes[0][-1] * (shapes[1][0] if kernel == "tconv" else 1)
        iters = 20 if ops_count < 1e11 else 5
        times = {}
        for tiling in TILINGS:
            out, call = _launcher(libs[kernel, tiling], kernel, ops)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"{case}: tiling {tiling} differs from the package's build")
            times[tiling] = cuda_ms(call, iters)
            emit({"case": case, "kernel": kernel, "shapes": shapes, "stride": stride,
                  "row_bytes": tiling[0], "stages": tiling[1], "max_bn": tiling[2],
                  "ms": times[tiling], "tops": ops_count / times[tiling] / 1e9})
            del out
        best = min(times, key=times.get)
        emit({"case": case, "best": list(best), "best_ms": times[best],
              "default": list(DEFAULT), "default_ms": times[DEFAULT],
              "default_over_best": times[DEFAULT] / times[best]})
        del ops, want
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
