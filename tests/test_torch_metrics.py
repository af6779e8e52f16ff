"""The port's saliency metrics and MATLAB imresize against the JAX package's
(``vinet_tpu/metrics``) on seeded maps and fixations: within 1e-12, NaN
wherever JAX gives NaN. Both sides are float64 numpy on the host."""

import math

import numpy as np
import pytest
import torch

import vinet_tpu.metrics.saliency as jax_sal
import vinet_tpu_torch.metrics.saliency as sal
from tests.torch_port_util import TORCH_THREADS
from vinet_tpu.metrics.imresize import imresize as jax_imresize
from vinet_tpu_torch.metrics import imresize as imresize_mod
from vinet_tpu_torch.metrics.imresize import imresize

torch.set_num_threads(TORCH_THREADS)
TOL = 1e-12
GT_HW = (45, 80)


def _gauss(h, w, cy, cx, sigma):
    y, x = np.mgrid[0:h, 0:w]
    return np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * sigma**2))


def _case(name: str):
    """(pred, gt, fix, other) for one case: GT and fixations at 45 x 80."""
    rng = np.random.default_rng(sum(map(ord, name)))  # a seed of its own per case
    h, w = GT_HW
    gt = _gauss(h, w, 20, 30, 8.0) + 0.05 * rng.random(GT_HW)
    pred = _gauss(h, w, 24, 36, 10.0) + 0.1 * rng.random(GT_HW)
    fix = np.zeros(GT_HW)
    fix[rng.integers(0, h, 9), rng.integers(0, w, 9)] = 1.0
    other = np.zeros(GT_HW)
    other[rng.integers(0, h, 30), rng.integers(0, w, 30)] = 1.0
    if name == "resize":  # pred 36 x 64 against GT 45 x 80: MATLAB's imresize first
        pred = _gauss(36, 64, 19, 29, 8.0) + 0.1 * rng.random((36, 64))
    elif name == "zero_pred":
        pred = np.zeros(GT_HW)
    elif name == "zero_gt":
        gt = np.zeros(GT_HW)
    elif name == "no_fixations":
        fix = np.zeros(GT_HW)
    elif name == "one_fixation":  # Borji needs two
        fix = np.zeros(GT_HW)
        fix[10, 20] = 1.0
    elif name == "float32_u8":  # maps as the CLIs load them: f32 from uint8 PNGs
        pred = np.round(255 * pred / pred.max()).astype(np.float32) / 255
        gt = np.round(255 * gt / gt.max()).astype(np.float32) / 255
    return pred, gt, fix, other


CASES = ["same_size", "resize", "zero_pred", "zero_gt", "no_fixations", "one_fixation",
         "float32_u8"]
# metric: (function name, arguments taken from the case, keyword arguments)
METRICS = {
    "cc": ("cc_score", ("pred", "gt"), {}),
    "sim": ("similarity_score", ("pred", "gt"), {}),
    "kldiv": ("kldiv_score", ("pred", "gt"), {}),
    "nss": ("nss_score", ("pred", "fix"), {}),
    "aucj": ("auc_judd", ("pred", "fix"), {}),
    "aucj_no_jitter": ("auc_judd", ("pred", "fix"), {"jitter": False}),
    "aucj_loss_py": ("auc_judd", ("pred", "fix"), {"convention": "loss_py"}),
    "aucb": ("auc_borji", ("pred", "fix"), {}),
    "sauc": ("auc_shuffled", ("pred", "fix", "other"), {}),
    "ig": ("info_gain", ("pred", "fix"), {}),
    "ig_base": ("info_gain", ("pred", "fix", "gt"), {}),
}


def _same(a: float, b: float) -> bool:
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("metric", sorted(METRICS))
def test_metric_matches_jax(metric, case):
    fn, names, kw = METRICS[metric]
    pred, gt, fix, other = _case(case)
    data = {"pred": pred, "gt": gt, "fix": fix, "other": other}
    args = [data[n] for n in names]
    want = getattr(jax_sal, fn)(*args, **kw)
    got = getattr(sal, fn)(*args, **kw)
    assert _same(got, want), (metric, case, got, want)
    # a tensor, as a predictor's map may come, gives the same number
    got_t = getattr(sal, fn)(*[torch.from_numpy(np.asarray(a)) for a in args], **kw)
    assert _same(got_t, want), (metric, case, got_t, want)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_nan_where_the_definitions_are_undefined():
    pred, gt, fix, other = _case("same_size")
    none = np.zeros(GT_HW)
    one = np.zeros(GT_HW)
    one[3, 4] = 1.0
    assert math.isnan(sal.auc_judd(pred, none))
    assert math.isnan(sal.auc_borji(pred, one))
    assert math.isnan(sal.auc_shuffled(pred, fix, none))
    assert not math.isnan(sal.auc_borji(pred, fix))


def test_auc_judd_jitter_is_default_rng_0():
    """The default jitter is the draw of default_rng(0), as JAX's; another
    generator moves the result."""
    pred, _, fix, _ = _case("same_size")
    assert sal.auc_judd(pred, fix) == sal.auc_judd(pred, fix, rng=np.random.default_rng(0))
    a = sal.auc_judd(np.ones(GT_HW), fix)  # a flat map: the jitter alone orders it
    b = sal.auc_judd(np.ones(GT_HW), fix, rng=np.random.default_rng(1))
    assert a == jax_sal.auc_judd(np.ones(GT_HW), fix) and a != b


def test_create_shuffle_map_matches_jax():
    rng = np.random.default_rng(3)
    maps = [(rng.random(GT_HW) > 0.98).astype(np.float64) for _ in range(6)]
    got = sal.create_shuffle_map(maps)
    want = jax_sal.create_shuffle_map(maps)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    assert np.array_equal(sal.create_shuffle_map(torch.from_numpy(m) for m in maps), want)


@pytest.mark.parametrize("in_hw,out_hw", [((64, 80), (17, 31)), ((17, 31), (64, 80)),
                                          ((224, 384), (7, 12)), ((36, 64), (45, 80)),
                                          ((9, 7), (4, 11))])
def test_imresize_shape_form_matches_jax(in_hw, out_hw):
    img = np.random.default_rng(0).random(in_hw) * 255.0
    got = imresize(img, out_hw)
    assert got.shape == out_hw
    assert np.max(np.abs(got - jax_imresize(img, out_hw))) <= TOL


@pytest.mark.parametrize("in_hw,scale,out_hw", [((224, 384), 1 / 32, (7, 12)),
                                                ((230, 390), 1 / 32, (8, 13)),
                                                ((64, 96), 0.5, (32, 48))])
def test_imresize_scale_form_matches_jax(in_hw, scale, out_hw):
    img = np.random.default_rng(1).random(in_hw)
    got = imresize(img, scale=scale)
    assert got.shape == out_hw  # MATLAB's ceil(size * scale)
    assert np.max(np.abs(got - jax_imresize(img, scale=scale))) <= TOL


@pytest.mark.parametrize("in_hw,out_hw", [((64, 80), (17, 31)), ((17, 31), (64, 80)),
                                          ((224, 384), (288, 360))])
def test_imresize_interior_matches_pil_bicubic(in_hw, out_hw):
    """PIL's float BICUBIC shares MATLAB's kernel and coordinate map and
    differs only at the borders (tests/test_imresize.py's oracle, same
    margins and tolerance)."""
    from PIL import Image

    img = np.random.default_rng(0).random(in_hw) * 255.0
    ref = np.asarray(Image.fromarray(img.astype(np.float32), mode="F").resize(
        (out_hw[1], out_hw[0]), Image.BICUBIC), dtype=np.float64)
    mh = int(math.ceil(2.5 * max(1.0, out_hw[0] / in_hw[0]))) + 2
    mw = int(math.ceil(2.5 * max(1.0, out_hw[1] / in_hw[1]))) + 2
    diff = np.abs(imresize(img, out_hw) - ref)[mh:-mh, mw:-mw]
    assert diff.max() < 1e-3  # PIL computes in float32


def test_imresize_constant_and_kernel():
    assert np.allclose(imresize(np.full((40, 60), 3.25), (13, 17)), 3.25, atol=1e-12)
    x = np.linspace(-3, 3, 61)
    from vinet_tpu.metrics.imresize import _cubic as jax_cubic

    assert np.array_equal(imresize_mod._cubic(x), jax_cubic(x))
