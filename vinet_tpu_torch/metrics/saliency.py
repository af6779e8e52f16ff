"""Offline saliency metrics (the MIT benchmark's definitions) in float64
numpy on the host, ``vinet_tpu/metrics/saliency.py``.

The reference's MATLAB suite (code_for_Metrics/: CC.m, NSS.m, KLdiv.m,
similarity.m, AUC_Judd.m, AUC_Borji.m, AUC_shuffled.m, IG.m) and its
shuffle-map construction (createShuffmap1.m). A map may be a numpy array or
a CPU or CUDA tensor; tensors are copied to the host in float64. Maps are
scored one at a time, as the evaluation CLIs call them.

The AUC sweeps sort and search (O(N log N)) where the reference loops over
fixations and pixels; the outputs are the same.

A bug of the reference's python port not copied: its loss.py auc_shuff
samples the saliency map at scrambled transposed indices
(``s_map[k % H - 1, k // H]``); here the sampling follows AUC_shuffled.m
(the values at the other map's fixation locations).
"""

from __future__ import annotations

import numpy as np
import torch

from vinet_tpu_torch.metrics.imresize import imresize


def _host(x) -> np.ndarray:
    """An array or a tensor (on any device) as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def _as2d(x) -> np.ndarray:
    x = _host(x)
    if x.ndim == 3 and x.shape[0] == 1:
        x = x[0]
    assert x.ndim == 2, x.shape
    return x


def _resize_to(sal: np.ndarray, shape) -> np.ndarray:
    """The prediction at the GT's size with MATLAB's imresize (antialiased
    bicubic), the resize every MATLAB metric applies."""
    if sal.shape == tuple(shape):
        return sal
    return imresize(sal, shape)


def _minmax(x: np.ndarray) -> np.ndarray:
    mn, mx = x.min(), x.max()
    return (x - mn) / (mx - mn) if mx > mn else np.zeros_like(x)


def cc_score(sal, gt) -> float:
    """Pearson correlation (CC.m): standardise both maps, corr2."""
    m1 = _resize_to(_as2d(sal), _as2d(gt).shape)
    m2 = _as2d(gt)
    m1 = (m1 - m1.mean()) / m1.std()
    m2 = (m2 - m2.mean()) / m2.std()
    a = m1 - m1.mean()
    b = m2 - m2.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def similarity_score(sal, gt) -> float:
    """Histogram intersection (similarity.m): min-max, then sum-normalise."""
    m1 = _resize_to(_as2d(sal), _as2d(gt).shape)
    m2 = _as2d(gt)
    if m1.any():
        m1 = _minmax(m1)
        m1 = m1 / m1.sum()
    if m2.any():
        m2 = _minmax(m2)
        m2 = m2 / m2.sum()
    if np.isnan(m1).all() or np.isnan(m2).all():
        return float("nan")
    return float(np.minimum(m1, m2).sum())


def nss_score(sal, fix) -> float:
    """Normalised scanpath saliency (NSS.m): the mean standardised saliency
    at the fixations; fix is binary."""
    f = _as2d(fix)
    m = _resize_to(_as2d(sal), f.shape)
    m = (m - m.mean()) / m.std()
    return float(m[f.astype(bool)].mean())


def kldiv_score(sal, gt) -> float:
    """KL divergence (KLdiv.m) with MATLAB's eps = 2^-52."""
    m2 = _as2d(gt)
    m1 = _resize_to(_as2d(sal), m2.shape)
    if m1.any():
        m1 = m1 / m1.sum()
    if m2.any():
        m2 = m2 / m2.sum()
    eps = np.finfo(np.float64).eps
    return float(np.sum(m2 * np.log(eps + m2 / (m1 + eps))))


def auc_judd(sal, fix, *, jitter: bool = True, rng=None, convention: str = "matlab") -> float:
    """AUC-Judd (AUC_Judd.m): an ROC sweep with a threshold at the saliency
    of each fixation. The jitter (uniform / 1e7, as AUC_Judd.m adds) is drawn
    from ``default_rng(0)`` unless rng is given.

    convention='matlab' takes fp = (above - i)/(Npix - Nfix) with 1-based i
    (AUC_Judd.m:75); 'loss_py' the reference python port's 0-based variant
    (loss.py:189), one count apart per threshold.
    """
    f = _as2d(fix)
    if not f.any():
        return float("nan")
    s = _resize_to(_as2d(sal), f.shape)
    if jitter:
        rng = np.random.default_rng(0) if rng is None else rng
        s = s + rng.random(s.shape) / 1e7
    s = _minmax(s)
    if np.isnan(s).all():
        return float("nan")

    S = s.ravel()
    F = f.ravel()
    sth = S[F > 0]
    n_fix = sth.size
    n_pix = S.size

    thresholds = np.sort(sth)[::-1]
    sorted_s = np.sort(S)
    above = n_pix - np.searchsorted(sorted_s, thresholds, side="left")  # S >= threshold
    k = np.arange(1, n_fix + 1, dtype=np.float64)
    tp = np.concatenate([[0.0], k / n_fix, [1.0]])
    sub = k if convention == "matlab" else k - 1.0
    fp = np.concatenate([[0.0], (above - sub) / (n_pix - n_fix), [1.0]])
    return float(np.trapezoid(tp, fp))


def auc_borji(sal, fix, *, n_splits: int = 100, step_size: float = 0.1, rng=None) -> float:
    """AUC-Borji (AUC_Borji.m): negatives drawn uniformly from all pixels."""
    f = _as2d(fix)
    if (f > 0).sum() <= 1:
        return float("nan")
    s = _minmax(_resize_to(_as2d(sal), f.shape))
    if np.isnan(s).all():
        return float("nan")
    rng = np.random.default_rng(0) if rng is None else rng

    S = s.ravel()
    sth = S[f.ravel() > 0]
    n_fix = sth.size
    randfix = S[rng.integers(0, S.size, size=(n_fix, n_splits))]
    return _threshold_sweep_auc(sth, randfix, step_size)


def auc_shuffled(sal, fix, other_map, *, n_splits: int = 100, step_size: float = 0.1,
                 rng=None) -> float:
    """Shuffled AUC (AUC_shuffled.m): the negatives are the saliency values
    at the fixations of OTHER frames (the shuffle map)."""
    f = _as2d(fix)
    if not f.any():
        return float("nan")
    s = _minmax(_resize_to(_as2d(sal), f.shape))
    if np.isnan(s).all():
        return float("nan")
    rng = np.random.default_rng(0) if rng is None else rng

    S = s.ravel()
    sth = S[f.ravel() > 0]
    n_fix = sth.size
    ind = np.flatnonzero(_host(other_map).ravel() > 0)
    if ind.size == 0:
        return float("nan")
    n_other = min(n_fix, ind.size)
    randfix = np.empty((n_other, n_splits))
    for i in range(n_splits):
        randfix[:, i] = S[rng.permutation(ind)[:n_other]]
    return _threshold_sweep_auc(sth, randfix, step_size)


def _threshold_sweep_auc(sth: np.ndarray, randfix: np.ndarray, step: float) -> float:
    """The AUC core of AUC_Borji.m and AUC_shuffled.m: for each split, sweep
    the thresholds 0:step:max in descending order; trapezoid over (fp, tp)."""
    n_fix = sth.size
    n_other = randfix.shape[0]
    sorted_sth = np.sort(sth)
    aucs = np.empty(randfix.shape[1])
    for si in range(randfix.shape[1]):
        cur = randfix[:, si]
        hi = float(max(sth.max(), cur.max()))
        thr = np.arange(0.0, hi + 1e-12, step)[::-1]
        tp = (n_fix - np.searchsorted(sorted_sth, thr, side="left")) / n_fix
        sorted_cur = np.sort(cur)
        fp = (n_other - np.searchsorted(sorted_cur, thr, side="left")) / n_other
        tp = np.concatenate([[0.0], tp, [1.0]])
        fp = np.concatenate([[0.0], fp, [1.0]])
        aucs[si] = np.trapezoid(tp, fp)
    return float(aucs.mean())


def info_gain(sal, fix, base_map=None) -> float:
    """Information gain over a baseline (IG.m): the mean log2 probability at
    the fixations, less the baseline's."""
    f = _as2d(fix)
    m = _minmax(_resize_to(_as2d(sal), f.shape))
    m = m / m.sum()
    eps = np.finfo(np.float64).eps
    locs = f.ravel().astype(bool)
    ml = np.log2(eps + m.ravel()[locs])
    if base_map is not None:
        b = _minmax(_resize_to(_as2d(base_map), f.shape))
        b = b / b.sum()
        ml = ml - np.log2(eps + b.ravel()[locs])
    return float(ml.mean())


def create_shuffle_map(fix_maps) -> np.ndarray:
    """The union (binarised sum) of a video's fixation maps, the sAUC
    negative set (createShuffmap1.m). eval_diem.m:63-65 also zeroes the
    current frame's fixations before AUC_shuffled; the callers do that."""
    acc = None
    for fm in fix_maps:
        fm = _host(fm)
        acc = fm.copy() if acc is None else acc + fm
    return (acc > 0).astype(np.float64)
