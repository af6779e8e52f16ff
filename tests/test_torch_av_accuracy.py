"""The port's AV agreement evaluation (``inference/accuracy.py::
evaluate_av_agreement``) and the AViNet the card evaluates it on
(``av_fixture_model``: the fixture's visual weights, the rest seeded by
``seeded_av_leaves``), against vinet_tpu's ``evaluate_av_agreement`` on the
same weights: the port's model exported in the reference's layout and read
by JAX's converter (``tests/torch_port_util.py::av_trees``).

The fixture videos are 224 x 384; here both packages take every 7th row and
12th column (32 x 32) and the model runs at 32 x 32, f32 on the CPU. JAX's
predictors run their own model, timeline and decode functions jitted with
the trees as arguments (``tests/torch_port_util.py::trees_as_arguments``).

Tolerance: the agreement (a mean CC over 64 frames) within 1e-4.
"""

import inspect

import pytest
import torch

import jax.numpy as jnp

import vinet_tpu.data.synthetic as jax_synthetic
import vinet_tpu.inference as jax_inference
import vinet_tpu.inference.streaming as jax_streaming
from tests.torch_port_util import (FIXTURE, TORCH_THREADS, av_trees, jax_folded,
                                   trees_as_arguments)
from vinet_tpu.inference import accuracy as jax_accuracy
from vinet_tpu_torch.inference import accuracy

torch.set_num_threads(TORCH_THREADS)
HW = (32, 32)


def test_av_fixture_model_is_the_fixture_and_the_seed():
    """The visual leaves are the fixture's; every other tensor but the
    sin/cos table and the BatchNorm counters is seeded_av_leaves'; norms'
    weights are drawn too, and the draw repeats with its seed."""
    model = accuracy.av_fixture_model(FIXTURE, seed=0, use_transformer=True, input_hw=HW)
    sd = model.state_dict()
    for k, v in accuracy.load_artifact(FIXTURE).state_dict().items():
        assert torch.equal(sd[f"visual_model.{k}"], v), k
    seeded = accuracy.seeded_av_leaves(model, 0)
    assert set(seeded) == {k for k in sd if not k.startswith("visual_model.")
                           and not k.endswith((".pe", "num_batches_tracked"))}
    for k, v in seeded.items():
        assert torch.equal(sd[k], v), k
    for k in ("transformer.transformer_encoder.layers.0.norm1.weight",
              "audionet.batchnorm1.weight"):
        assert 0.5 < float(sd[k].min()) and float(sd[k].max()) < 1.5 and float(sd[k].std()) > 0
    assert all(torch.equal(a, b) for a, b in zip(seeded.values(),
                                                 accuracy.seeded_av_leaves(model, 0).values()))
    assert not torch.equal(seeded["bilinear.weight"],
                           accuracy.seeded_av_leaves(model, 1)["bilinear.weight"])


@pytest.fixture
def small_videos_and_jax_predictors(monkeypatch):
    """Both packages' fixture videos cut to 32 x 32; JAX's predictors built
    on folded trees with their functions jitted with the trees as arguments."""
    real = jax_synthetic.make_fixture_video

    def small(kind, n_frames=96, seed=100):
        return tuple(a[:, ::7, ::12] for a in real(kind, n_frames=n_frames, seed=seed))

    monkeypatch.setattr(jax_synthetic, "make_fixture_video", small)
    monkeypatch.setattr(accuracy, "make_fixture_video", small)
    parity_cls, stream_cls = jax_inference.SlidingWindowPredictor, jax_streaming.AVStreamingPredictor

    def parity(model, params, state, **kw):
        pred = parity_cls(model, params, state, fold=False, **kw)
        trees_as_arguments(pred, "model", pred._model_fn().__wrapped__)
        return pred

    def stream(model, params, state, **kw):
        pred = stream_cls(model, params, state, fold=False, **kw)
        trees_as_arguments(pred, "timeline", pred._build_timeline())
        trees_as_arguments(pred, "decode", pred._build_decode())
        return pred

    monkeypatch.setattr(jax_inference, "SlidingWindowPredictor", parity)
    monkeypatch.setattr(jax_streaming, "AVStreamingPredictor", stream)


def test_evaluate_av_agreement_matches_jax(small_videos_and_jax_predictors):
    """The blob kind, 64 frames, batch 16, chunk 128, f32: the same rows
    and the same agreement."""
    model, params, state = av_trees(False, input_hw=HW)
    want = jax_accuracy.evaluate_av_agreement(model, *jax_folded(params, state), kinds=("blob",),
                                              n_frames=64, dtype=jnp.float32)
    port = accuracy.av_fixture_model(FIXTURE, seed=0, input_hw=HW)
    got = accuracy.evaluate_av_agreement(port, kinds=("blob",), n_frames=64,
                                         dtype=torch.float32, device="cpu")
    print(f"agreement port {got['agreement_min']:.6f}, JAX {want['agreement_min']:.6f}")
    assert set(got) == set(want) and got["n_frames"] == want["n_frames"] == 64
    assert [r["kind"] for r in got["fixtures"]] == [r["kind"] for r in want["fixtures"]]
    for key in ("agreement_min", "agreement_mean"):
        assert abs(got[key] - want[key]) < 1e-4, key
    assert 0.5 < got["agreement_min"] <= 1.0


def test_av_agreement_defaults_match_jax():
    """The same defaults as JAX's, the dtype bf16 and the device the card."""
    got = inspect.signature(accuracy.evaluate_av_agreement).parameters
    want = inspect.signature(jax_accuracy.evaluate_av_agreement).parameters
    for k, p in want.items():
        if k not in ("model", "params", "state", "dtype"):
            assert got[k].default == p.default, k
    assert got["dtype"].default is torch.bfloat16 and got["device"].default == "cuda"
