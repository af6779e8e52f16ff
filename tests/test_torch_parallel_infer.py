"""Data-parallel and stream-parallel inference of vinet_tpu_torch on 2 gloo
ranks on the CPU, and the time-sharded pyramid, against vinet_tpu.

One world of 2 spawned ranks (``tests/torch_port_util.py::rank_infer``,
``create_mesh()``) runs while this process computes the references, all in
f32, within ``tests/test_inference_sharded.py``'s rtol 1e-4 / atol 2e-5:

- ``SlidingWindowPredictor(mesh=)`` of ViNet(3, 8) (seeded ``bn_tree``
  trees, 24 frames of 32 x 32, clip 8, batch 4) against the JAX package's
  ``SlidingWindowPredictor(mesh=create_mesh(jax.devices()[:2]))`` on the
  root conftest's virtual CPU devices (pre-folded trees as arguments), on
  both ranks;
- ``StreamingPredictor`` (chunk 16) and ``AVStreamingPredictor`` (the
  seeded AViNet at 32 x 32, 64 frames, chunk 64) with ``mesh=`` against the
  port's unsharded predictors;
- ``SlidingWindowPredictor(mesh=, audio_fn=)`` of the same AViNet (batch 4:
  each rank runs 2 windows with their excerpts, the warm-up rows reversed)
  against the unsharded predictor and against the JAX package's
  ``SlidingWindowPredictor(mesh=)`` with audio on 2 virtual CPU devices
  (``av_trees``' trees, pre-folded, as arguments);
- ``MultiLiveServer(stream_mesh=)`` of the same ViNet(3, 8) with 2 streams
  of 48 frames, and ``AVMultiLiveServer(stream_mesh=)`` of the AViNet with
  2 streams of 64 frames and their own waveforms (one stream a rank, micro
  16), against the unsharded servers: every stream's maps on both ranks;
- ``streaming_pyramid_tsharded`` on one 128-frame chunk (64-frame segments,
  the 56-frame halo) against the JAX package's on a 2-device mesh at every
  position of the four timelines, the chunk's edges included: both pad the
  global edges with zero frames. The JAX package's refusals: segments
  shorter than the halo, a batch or a stream count the data axis does not
  divide, ``mesh=`` with ``stream_mesh``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_util import (INFER_AV_LIVE, TORCH_THREADS, World, av_trees, bn_tree,
                                   infer_predictors, jax_folded, rank_infer,
                                   trees_as_arguments)
from vinet_tpu.inference.engine import SlidingWindowPredictor as JaxPredictor
from vinet_tpu.inference.streaming import streaming_pyramid_tsharded as jax_tsharded
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu.parallel import create_mesh as jax_create_mesh
from vinet_tpu_torch.inference import MultiLiveServer, SlidingWindowPredictor
from vinet_tpu_torch.inference.streaming import streaming_pyramid_tsharded
from vinet_tpu_torch.parallel import Mesh

torch.set_num_threads(TORCH_THREADS)
TOL = dict(rtol=1e-4, atol=2e-5)  # tests/test_inference_sharded.py's


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jm = JaxViNet(3, 8)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    trees = (bn_tree(shapes[0], rng), bn_tree(shapes[1], rng))
    fixture = (rng.integers(0, 256, (24, 32, 32, 3), dtype=np.uint8),
               rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8),
               (0.1 * rng.standard_normal((64, 70560, 1))).astype(np.float32),
               rng.integers(0, 256, (2, 48, 32, 32, 3), dtype=np.uint8),
               rng.integers(0, 256, (2, 64, 32, 32, 3), dtype=np.uint8),
               [(0.1 * rng.standard_normal(int(64 / INFER_AV_LIVE["fps"]
                                               * INFER_AV_LIVE["audio_fs"]))).astype(np.float32)
                for _ in range(2)])
    x128 = rng.standard_normal((1, 3, 128, 32, 32)).astype(np.float32)
    world = World(rank_infer, 2, trees, fixture, x128, workdir=tmp_path_factory.mktemp("world"))

    mesh = jax_create_mesh(jax.devices()[:2])
    jp = JaxPredictor(jm, *jax_folded(*trees), clip_size=8, batch=4, dtype=jnp.float32,
                      fold=False, mesh=mesh)
    trees_as_arguments(jp, "model", jp._model_fn().__wrapped__)
    jax_parity = {i: np.asarray(m) for i, m in jp.predict_video(fixture[0])}
    av_model, av_params, av_state = av_trees(False, input_hw=(32, 32))
    jav = JaxPredictor(av_model, *jax_folded(av_params, av_state), clip_size=32, batch=4,
                       dtype=jnp.float32, fold=False, mesh=mesh)
    trees_as_arguments(jav, "model", jav._model_fn().__wrapped__)
    jax_av_parity = {i: np.asarray(m) for i, m in
                     jav.predict_video(fixture[1], audio_fn=lambda s: fixture[2][s])}
    tsharded = jax.jit(lambda p, s, x: jax_tsharded(p, s, x, mesh))
    jax_tl = [np.moveaxis(np.asarray(y), -1, 1) for y in tsharded(
        trees[0]["backbone"], trees[1]["backbone"], np.moveaxis(x128, 1, -1))]
    return {"ranks": world.results(), "one": infer_predictors(trees, fixture),
            "jax_parity": jax_parity, "jax_av_parity": jax_av_parity, "jax_tl": jax_tl}


def _maps_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want) and len(got) > 0
    for i in want:
        np.testing.assert_allclose(got[i], want[i], err_msg=f"frame {i}", **TOL)


def test_sliding_window_data_parallel_matches_jax(run):
    assert sorted(run["jax_parity"]) == list(range(24))
    for rank in run["ranks"]:
        _maps_close(rank["parity"], run["jax_parity"])


def test_av_sliding_window_data_parallel_matches_jax(run):
    assert sorted(run["jax_av_parity"]) == list(range(64))
    for rank in run["ranks"]:
        _maps_close(rank["av_parity"], run["jax_av_parity"])


@pytest.mark.parametrize("path", ["parity", "streaming", "av_parity", "av_streaming"])
def test_data_parallel_predictors_equal_one_process(run, path):
    for rank in run["ranks"]:
        _maps_close(rank[path], run["one"][path])


def test_stream_parallel_server_equals_one_process(run):
    for rank in run["ranks"]:
        assert sorted(rank["multilive"]) == [0, 1]
        for s in range(2):
            assert sorted(rank["multilive"][s]) == list(range(48))
            _maps_close(rank["multilive"][s], run["one"]["multilive"][s])


def test_av_stream_parallel_server_equals_one_process(run):
    for rank in run["ranks"]:
        assert sorted(rank["av_multilive"]) == [0, 1]
        for s in range(2):
            assert sorted(rank["av_multilive"][s]) == list(range(64))
            _maps_close(rank["av_multilive"][s], run["one"]["av_multilive"][s])


def test_tsharded_pyramid_matches_jax_everywhere(run):
    for rank in run["ranks"]:
        for got, want in zip(rank["tsharded"], run["jax_tl"]):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _mesh(data: int) -> Mesh:
    return Mesh({"data": data, "model": 1}, (0, 0), {"data": None, "model": None})


def test_parallel_paths_refuse_what_jax_refuses():
    with pytest.raises(ValueError, match="shorter than the halo"):
        streaming_pyramid_tsharded(None, torch.zeros((1, 3, 64, 32, 32)), _mesh(8))
    with pytest.raises(ValueError, match="multiple of 8"):
        streaming_pyramid_tsharded(None, torch.zeros((1, 3, 120, 32, 32)), _mesh(2))
    with pytest.raises(ValueError, match="not divisible by the 2-way data axis"):
        SlidingWindowPredictor(torch.nn.Identity(), batch=3, mesh=_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="not divisible by the 2-way data axis"):
        MultiLiveServer(None, streams=3, stream_mesh=_mesh(2))
    with pytest.raises(ValueError, match="cannot be combined"):
        MultiLiveServer(None, streams=2, stream_mesh=_mesh(2), mesh=_mesh(2))
