"""The port's accuracy evaluation (``vinet_tpu_torch/inference/accuracy.py``)
against the JAX package's: the orchestration (videos, seeds, strides, keys,
means) held exactly with both packages' predictors replaced by one
deterministic stub, and ``load_artifact``'s weights. The accuracy of the
fixture checkpoint itself is the slow test at the end (full width, f32, on
the CPU) and ``chip_smoke.py``'s accuracy phase (bf16 on the card)."""

import os
import types

import numpy as np
import pytest
import torch

import vinet_tpu.inference as jax_inference
import vinet_tpu.inference.streaming as jax_streaming
from tests.torch_port_util import FIXTURE, TORCH_THREADS, fixture_trees
from vinet_tpu.inference import accuracy as jax_accuracy
from vinet_tpu_torch.inference import accuracy

torch.set_num_threads(TORCH_THREADS)


def _stub(mode: str, calls: list):
    """A predictor class standing for both packages' (their constructors'
    arguments differ): each map is the frame's mean intensity plus noise
    seeded by (mode, frame index, the frame's first pixel), emitted in
    reverse order; the constructor's keyword arguments go to calls."""

    class Stub:
        def __init__(self, *args, **kwargs):
            calls.append((mode, kwargs))

        def predict_video(self, frames):
            for i in reversed(range(frames.shape[0])):
                rng = np.random.default_rng([len(mode), i, int(frames[i, 0, 0, 0])])
                base = frames[i].astype(np.float64).mean(-1) / 255.0
                yield i, (base + 0.3 * rng.random(base.shape)).astype(np.float32)

    return Stub


@pytest.fixture
def stubbed(monkeypatch):
    """Both packages' predictors replaced by the same stubs; returns the
    constructor calls of (JAX, port)."""
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_inference, "SlidingWindowPredictor", _stub("parity", jax_calls))
    monkeypatch.setattr(jax_streaming, "StreamingPredictor", _stub("streaming", jax_calls))
    monkeypatch.setattr(accuracy, "SlidingWindowPredictor", _stub("parity", port_calls))
    monkeypatch.setattr(accuracy, "StreamingPredictor", _stub("streaming", port_calls))
    return jax_calls, port_calls


MODEL = types.SimpleNamespace(clip_size=32)


@pytest.mark.parametrize("stride", [1, 3])
def test_evaluate_modes_matches_jax(stubbed, stride):
    jax_calls, port_calls = stubbed
    kw = dict(n_frames=10, seeds=(100, 101), parity_stride=stride, batch=4, chunk=64)
    want = jax_accuracy.evaluate_modes(MODEL, None, None, dtype=np.float32, **kw)
    got = accuracy.evaluate_modes(MODEL, dtype=torch.float32, device="cpu", **kw)
    assert got == want  # every key and every mean, exactly
    assert got["frames_scored"] == 2 * len(range(0, 10, stride))
    assert set(got) == {"n_frames", "parity_stride", "frames_scored", "parity_cc",
                        "streaming_cc", "cc_delta", "agreement_cc", "videos"}
    assert [r["seed"] for r in got["videos"]] == [100, 101]
    # the port builds each predictor once, with the model's clip and the options
    assert port_calls == [("parity", dict(clip_size=32, batch=4, dtype=torch.float32,
                                          device="cpu")),
                          ("streaming", dict(clip_size=32, batch=4, dtype=torch.float32,
                                             device="cpu", chunk=64))]
    assert {m for m, _ in jax_calls} == {"parity", "streaming"}


def test_evaluate_fixture_suite_matches_jax(stubbed):
    kw = dict(n_frames=8, seed=100, batch=4, chunk=64)
    want = jax_accuracy.evaluate_fixture_suite(MODEL, None, None, dtype=np.float32, **kw)
    got = accuracy.evaluate_fixture_suite(MODEL, dtype=torch.float32, device="cpu", **kw)
    assert got == want
    assert [r["kind"] for r in got["fixtures"]] == list(accuracy.FIXTURE_KINDS)
    two = accuracy.evaluate_fixture_suite(MODEL, kinds=("scale", "blob"), dtype=torch.float32,
                                          device="cpu", **kw)
    assert two == jax_accuracy.evaluate_fixture_suite(MODEL, None, None, kinds=("scale", "blob"),
                                                      dtype=np.float32, **kw)


def test_defaults_match_jax():
    """The same defaults as JAX's, the dtype bf16 and the device the card."""
    import inspect

    for name in ("evaluate_modes", "evaluate_fixture_suite"):
        got = inspect.signature(getattr(accuracy, name)).parameters
        want = inspect.signature(getattr(jax_accuracy, name)).parameters
        for k, p in want.items():
            if k in ("model", "params", "state", "dtype"):
                continue
            assert got[k].default == p.default, (name, k)
        assert got["dtype"].default is torch.bfloat16 and got["device"].default == "cuda"


def test_load_artifact_gives_the_fixture_values():
    from vinet_tpu.io.export import trees_to_torch_state_dict

    model = accuracy.load_artifact(FIXTURE)
    assert model.clip_size == 32 and model.num_hier == 3
    want = trees_to_torch_state_dict(*fixture_trees())
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        t = got[k]
        if k.endswith("num_batches_tracked"):
            continue
        assert t.dtype == torch.float32, k
        assert np.array_equal(t.numpy(), np.asarray(v, np.float32)), k


@pytest.mark.slow
def test_fixture_artifact_accuracy_cpu_f32():
    """tests/test_streaming_ft_artifact.py's bounds on the port, f32 on the
    CPU at full width (the blob video, then the 5-kind suite)."""
    if not os.path.exists(FIXTURE):
        pytest.fail(f"committed artifact missing: {FIXTURE}")
    model = accuracy.load_artifact(FIXTURE)
    r = accuracy.evaluate_modes(model, n_frames=72, seeds=(100,), dtype=torch.float32,
                                parity_stride=4, batch=8, device="cpu")
    assert r["parity_cc"] > 0.70, r
    assert r["streaming_cc"] > 0.65, r
    assert r["cc_delta"] >= -0.08, r
    assert r["agreement_cc"] >= 0.98, r
    s = accuracy.evaluate_fixture_suite(model, n_frames=72, dtype=torch.float32, batch=8,
                                        device="cpu")
    assert len(s["fixtures"]) == 5, s
    for row in s["fixtures"]:
        assert row["cc_delta"] >= -0.10, row
        assert row["agreement_cc"] >= 0.97, row
    assert s["cc_delta_min"] >= -0.10, s
    assert s["cc_delta_mean"] >= -0.08, s
