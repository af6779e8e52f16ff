"""The port's EMD: its own native library (built from
``vinet_tpu_torch/native/emd/emd_hat.cpp`` into ``vinet_tpu_torch/_build/``)
against the JAX package's native solver (within 1e-12), against the JAX
package's exact LP (``tests/test_emd.py``'s tolerance), on hand-checkable
cases; and a build that fails raises instead of solving an LP."""

from pathlib import Path

import numpy as np
import pytest
import torch

import vinet_tpu.metrics.emd as jax_emd
from tests.torch_port_util import TORCH_THREADS, build_jax_emd
from vinet_tpu_torch.metrics import emd
from vinet_tpu_torch.ops import build

torch.set_num_threads(TORCH_THREADS)
REPO = Path(__file__).resolve().parent.parent
TOL = 1e-12
LP_REL, LP_ABS = 1e-6, 1e-9  # tests/test_emd.py:66


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's emd_hat on its own native solver (a copy built here)."""
    lib = build_jax_emd(tmp_path_factory.mktemp("jax_emd"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_emd, "_load_native", lambda: lib)
        yield jax_emd


def _jax_lp(fn, *args, **kwargs):
    """Call fn of JAX's emd module with its native solver unloaded, so that
    emd_hat and emd_score solve JAX's own LP (scipy's HiGHS)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_emd, "_load_native", lambda: None)
        return fn(*args, **kwargs)


def _grid_distance(n):
    i = np.arange(n, dtype=float)
    return np.abs(i[:, None] - i[None, :])


def _random_problem(seed, n=30):
    rng = np.random.default_rng(seed)
    p = rng.random(n)
    q = rng.random(n)
    pts = rng.random((n, 2)) * 10
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    np.fill_diagonal(d, 0.0)
    return p / p.sum(), q / q.sum(), d


def test_native_library_builds_under_the_package():
    so = build.build_host(emd.SOURCE)
    assert emd.SOURCE == REPO / "vinet_tpu_torch" / "native" / "emd" / "emd_hat.cpp"
    assert so.parent == REPO / "vinet_tpu_torch" / "_build"
    assert so.name.startswith("libemd_hat-") and so.suffix == ".so"
    assert so.with_suffix(".log").exists()  # the compiler's report beside it
    assert Path(emd._load_native()._name) == so


@pytest.mark.parametrize("seed", range(5))
def test_native_matches_jax_native_and_the_lp(jax_native, seed):
    p, q, d = _random_problem(seed)
    got = emd.emd_hat(p, q, d)
    assert abs(got - jax_native.emd_hat(p, q, d)) <= TOL
    assert got == pytest.approx(_jax_lp(jax_emd.emd_hat, p, q, d), rel=LP_REL, abs=LP_ABS)
    # unequal masses, a penalty and a threshold go through both solvers alike
    kw = dict(extra_mass_penalty=0.7, threshold=4.0)
    got = emd.emd_hat(p * 1.3, q, d, **kw)
    assert abs(got - jax_native.emd_hat(p * 1.3, q, d, **kw)) <= TOL
    assert got == pytest.approx(_jax_lp(jax_emd.emd_hat, p * 1.3, q, d, **kw),
                                rel=LP_REL, abs=LP_ABS)


# (P, Q, keyword arguments, hand-checked value): tests/test_emd.py's cases
HAND = {
    "identical": ([0.2, 0.3, 0.5], [0.2, 0.3, 0.5], {}, 0.0),
    "single_shift": ([1.0, 0.0], [0.0, 1.0], {}, 1.0),
    "split_mass": ([1.0, 0.0, 0.0], [0.0, 0.5, 0.5], {}, 0.5 * 1 + 0.5 * 2),
    "penalty": ([2.0, 0.0], [0.0, 1.0], {"extra_mass_penalty": 5.0}, 6.0),
    "penalty_max_d": ([2.0, 0.0], [0.0, 1.0], {"extra_mass_penalty": -1.0}, 2.0),
    "far": ([1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0], {}, 3.0),
    "threshold": ([1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0], {"threshold": 1.5}, 1.5),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_hand_checked_cases(jax_native, case):
    p, q, kw, want = HAND[case]
    d = _grid_distance(len(p))
    got = emd.emd_hat(np.array(p), np.array(q), d, **kw)
    assert got == pytest.approx(want, abs=LP_ABS)
    assert _jax_lp(jax_emd.emd_hat, np.array(p), np.array(q), d, **kw) == \
        pytest.approx(want, rel=LP_REL, abs=LP_ABS)
    assert abs(got - jax_native.emd_hat(np.array(p), np.array(q), d, **kw)) <= TOL


def test_flow_output_consistent(jax_native):
    rng = np.random.default_rng(1)
    n = 10
    p = rng.random(n)
    q = rng.random(n)
    q *= p.sum() / q.sum()
    d = _grid_distance(n)
    val, flow = emd.emd_hat(p, q, d, return_flow=True)
    np.testing.assert_allclose(flow.sum(), p.sum(), rtol=1e-6)
    np.testing.assert_allclose((flow * d).sum(), val, rtol=1e-6)
    np.testing.assert_array_less(flow.sum(axis=1), p + 1e-6)
    jval, jflow = jax_native.emd_hat(p, q, d, return_flow=True)
    assert abs(val - jval) <= TOL and np.max(np.abs(flow - jflow)) <= TOL


@pytest.mark.parametrize("case", ["near", "far", "same", "random", "resized", "tensor"])
def test_emd_score_matches_jax(jax_native, case):
    """EMD.m's downsize 1/32, clamp, column-major flattening and emd_hat,
    held on the maps of tests/test_emd.py and on random maps."""
    y, x = np.mgrid[0:224, 0:384]
    gt = np.exp(-((y - 112) ** 2 + (x - 150) ** 2) / (2 * 20.0**2))
    rng = np.random.default_rng(5)
    pred = {"near": np.exp(-((y - 112) ** 2 + (x - 180) ** 2) / (2 * 20.0**2)),
            "far": np.exp(-((y - 40) ** 2 + (x - 330) ** 2) / (2 * 20.0**2)),
            "same": gt, "random": rng.random((224, 384)), "resized": rng.random((112, 200)),
            "tensor": np.exp(-((y - 60) ** 2 + (x - 100) ** 2) / 1800.0).astype(np.float32)}[case]
    want = jax_native.emd_score(pred, gt)
    got = emd.emd_score(torch.from_numpy(pred) if case == "tensor" else pred, gt)
    assert abs(got - want) <= TOL, (got, want)
    if case == "same":
        assert got == pytest.approx(0.0, abs=1e-6)
    if case == "far":
        assert got > emd.emd_score(np.exp(-((y - 112) ** 2 + (x - 180) ** 2) / 800.0), gt) > 0


def _broad_prediction_case(seed):
    """A small GT blob against a broad noisy prediction at 224 x 384, the
    shape of a real model's map. On maps of this kind the JAX package's
    native solver may never return: rounding leaves reduced costs of about
    -1e-14 on zero-cost residual cycles, its Dijkstra relaxes them without
    end and the queue outgrows the memory (std::bad_alloc). No test calls
    it on them."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:224, 0:384].astype(np.float64)
    cy, cx, s = rng.uniform(16, 208), rng.uniform(16, 368), rng.uniform(6, 16)
    gt = np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s))
    pred = np.exp(-((y - rng.uniform(0, 224)) ** 2 + (x - rng.uniform(0, 384)) ** 2) / 1800.0)
    return pred + 0.05 * rng.random((224, 384)), gt


@pytest.mark.parametrize("seed", [5, 7, 11])
def test_native_solves_what_the_jax_native_solver_cannot(seed):
    """The port's solver takes negative rounding in the reduced costs as 0 and
    settles each node once, so it returns, at the value of the JAX package's
    emd_score on its own LP (its imresize, its clamp, its flattening)."""
    pred, gt = _broad_prediction_case(seed)
    got = emd.emd_score(pred, gt)
    assert got == pytest.approx(_jax_lp(jax_emd.emd_score, pred, gt), rel=LP_REL, abs=LP_ABS)


def test_failed_build_raises_instead_of_solving_the_lp(tmp_path, monkeypatch):
    """Where the JAX package falls back to an LP without a word, the port
    raises with the compiler's failure."""
    p, q, d = _random_problem(0, n=6)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", "false")
    emd._load_native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="false failed building emd_hat.cpp"):
            emd.emd_hat(p, q, d)
        with pytest.raises(RuntimeError):
            emd.emd_score(np.random.default_rng(0).random((64, 96)), np.ones((64, 96)))
        assert list((tmp_path / "_build").glob("*.so")) == []
    finally:
        emd._load_native.cache_clear()
