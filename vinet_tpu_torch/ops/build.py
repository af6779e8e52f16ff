"""Build the package's CUDA and host C++ sources into shared libraries with a
plain C interface and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` for ``sm_90a``,
into ``vinet_tpu_torch/_build/lib<name>-<hash>.so``; the hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source builds anew. The compiler's report
(``-Xptxas -v``: registers, shared memory, spills) is kept beside the library
as ``.log``. Host C++ (``native/emd/emd_hat.cpp``) takes the host compiler
(``$CXX``, else ``c++``) with ``HOST_CXX_FLAGS`` the same way
(``build_host``); a failed build raises with the compiler's output. Nothing is
built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_loaded: dict = {}


def refuse_autograd(entry: str, *tensors) -> None:
    """Raise if an autograd graph would run through a CUDA entry: the kernels
    write their outputs through ctypes, which records no backward, so the
    result would silently cut the graph. No Pallas kernel of the JAX package
    has a VJP either; training takes the model's plain differentiable route."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{entry} has no backward: call it under torch.no_grad() or "
                           "torch.inference_mode(), or on tensors that do not require grad")


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return nvcc


def _hashed(name: str, src: bytes, flags: tuple) -> Path:
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    return _hashed(name, src, NVCC_FLAGS)


def _compile(compiler: str, flags: tuple, source: Path, so: Path) -> Path:
    """Compile source into so, the report beside it as .log; raise with the
    compiler's output if it fails."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(source)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # the compiler is missing
        raise RuntimeError(f"{compiler} failed building {source.name}: {e}") from e
    so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed building {source.name} (exit {res.returncode}):"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return so


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless this source's library already exists."""
    so = library_path(name)
    if so.exists():
        return so
    return _compile(find_nvcc(), NVCC_FLAGS, CSRC_DIR / f"{name}.cu", so)


def build_host(source: Path) -> Path:
    """Compile a host C++ source (``native/...``) with ``$CXX`` (else
    ``c++``) into ``BUILD_DIR/lib<stem>-<hash>.so`` unless that library
    exists; the hash covers the source and the flags."""
    so = _hashed(source.stem, source.read_bytes(), HOST_CXX_FLAGS)
    if so.exists():
        return so
    return _compile(os.environ.get("CXX") or "c++", HOST_CXX_FLAGS, source, so)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; one handle per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
