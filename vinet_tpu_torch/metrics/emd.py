"""EMD saliency metric on the package's native C++ emd_hat,
``vinet_tpu/metrics/emd.py``.

The reference's EMD.m and FastEMD mex chain: maps downsized 1/32,
sum-normalised, the full Euclidean ground-distance matrix, emd_hat with
extra_mass_penalty 0.

The solver (successive shortest paths on a min-cost flow, C ABI) is the
package's own copy, ``native/emd/emd_hat.cpp``, built at first use by
``ops/build.py::build_host`` into ``_build/libemd_hat-<hash>.so``. Two
differences from the JAX package:

- a failed build raises with the compiler's output, where the JAX package
  quietly solves an LP instead. The port has no second solver;
- the solver's Dijkstra takes a reduced cost that rounding left below 0 as 0
  and settles each node once. The JAX package's copy relaxes such costs
  without end on many 224 x 384 maps (a broad noisy prediction against a
  small GT blob) until its queue exhausts the memory; where it returns, the
  two agree within 1e-12.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from vinet_tpu_torch.metrics.imresize import imresize
from vinet_tpu_torch.metrics.saliency import _host
from vinet_tpu_torch.ops import build

SOURCE = build.PKG_DIR / "native" / "emd" / "emd_hat.cpp"


@functools.lru_cache(maxsize=1)
def _load_native() -> ctypes.CDLL:
    """Build (if needed) and load the native solver; raises if it does not
    build. A successful load is kept for the process."""
    lib = ctypes.CDLL(str(build.build_host(SOURCE)))
    lib.emd_hat_compute.restype = ctypes.c_double
    lib.emd_hat_compute.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def emd_hat(P, Q, D, *, extra_mass_penalty: float = 0.0, threshold: float = 0.0,
            return_flow: bool = False):
    """emd_hat(P, Q, D): the min-cost transport of min(|P|, |Q|) mass, plus
    extra_mass_penalty * ||P| - |Q|| (penalty -1 means max(D))."""
    P = np.ascontiguousarray(_host(P)).ravel()
    Q = np.ascontiguousarray(_host(Q)).ravel()
    n = P.size
    D = np.ascontiguousarray(_host(D)).reshape(n, n)
    lib = _load_native()
    flow = np.zeros((n, n), np.float64) if return_flow else None
    cp = ctypes.POINTER(ctypes.c_double)
    val = lib.emd_hat_compute(
        P.ctypes.data_as(cp), Q.ctypes.data_as(cp), D.ctypes.data_as(cp),
        n, extra_mass_penalty, threshold,
        flow.ctypes.data_as(cp) if flow is not None else None,
    )
    return (val, flow) if return_flow else val


def emd_score(saliency_map, fixation_map, *, downsize: int = 32) -> float:
    """EMD.m: downsize both maps (imresize's scale form: ceil(size /
    downsize), antialiased bicubic; EMD.m:33-34), sum-normalise, Euclidean
    ground distance over the grid, emd_hat with zero extra-mass penalty."""
    fm = _host(fixation_map)
    im1 = imresize(fm, scale=1.0 / downsize)
    h, w = im1.shape
    im2 = imresize(_host(saliency_map), (h, w))
    # bicubic ringing can give small negative masses, which EMD.m hands to
    # FastEMD unguarded (undefined for a negative supply); they are clamped
    # to 0 before normalising, as the JAX package does, so the LP is posed
    im1 = np.maximum(im1, 0.0)
    im2 = np.maximum(im2, 0.0)
    im1 = im1 / im1.sum()
    im2 = im2 / im2.sum()

    # column-major flattening, as MATLAB's loop (EMD.m:47-59); D is symmetric
    # in grid distance, so the order only needs to be the same for both maps
    r, c = np.meshgrid(np.arange(h), np.arange(w), indexing="xy")
    rr = r.ravel()
    cc = c.ravel()
    D = np.sqrt((rr[:, None] - rr[None, :]) ** 2 + (cc[:, None] - cc[None, :]) ** 2)
    return float(emd_hat(im1.T.ravel(), im2.T.ravel(), D, extra_mass_penalty=0.0))
