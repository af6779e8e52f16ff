"""Data- and model-parallel training of vinet_tpu_torch on 2 gloo ranks on
the CPU, against one process on the global batch, and against the JAX
package's step forward on a 2-device data mesh.

One world of 2 spawned ranks (``tests/torch_port_util.py::rank_train``)
runs while this process computes the references and JAX's side:

- ``SyncBatchNorm`` over the 2 ranks, 3-D and 1-D (SoundNet's), each rank
  holding half the batch: the output, the input's and the affine
  parameters' gradients (summed over the ranks) and the running statistics
  equal nn.BatchNorm on the concatenated batch, float64, within 1e-12 of
  each tensor's largest value;
- the data-2 train step (``init_train_state``/``make_train_step`` with
  ``mesh=create_mesh(2)``, the global batch on both ranks) of ViNet(3, 8)
  at (4, 8, 32, 32) and with grad_accum 2 at (8, 8, 32, 32), and of
  AViNetFusion(clip 8, 64 x 96) at batch 2 with dropout on (seed 7): loss,
  gradient norm, every updated parameter and statistic within 1e-10
  (relative, float64) of one process's step on the global batch, taken by
  one rank (a float64 state of the full-width model is too big to hand
  back) or, for ViNet at grad_accum 1, here from rank 0's checkpoint, and
  the same state on both ranks (a digest);
- the (data 1 x model 2) step, its parameters and Adam state sharded over
  the model axis, in the same way, and of a small model with a transposed
  convolution (``TinyTransposed``), whose weight shards on dim 1 (JAX's O
  axis), its step and its gathered Adam state against one process's; its checkpoint (written by rank 0 alone,
  unsharded) loads into a one-process state here and equals this process's
  step, Adam state included, and an unsharded checkpoint (the data-2
  state's, written as one process writes its own) loads into the model-2
  state, each shard and its Adam state cut from the file;
- JAX: the loss and the new BatchNorm statistics of
  ``torch_port_util.jax_train_forward`` on a 2-device data mesh of the
  root conftest's virtual CPU devices, on the same seeded f32 trees
  (``bn_tree``) and batch, against the port's data-2 float64 step: within
  1e-5, the bound of the port's other train-step tests against JAX.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec

import shutil

from tests.torch_port_util import (TORCH_THREADS, TRAIN_CASES, World, av_batch, bn_tree,
                                   float64_step, jax_train_forward, port_vinet, rank_train,
                                   rel_err, seeded_bn, step_errors)
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu.parallel import create_mesh as jax_create_mesh
from vinet_tpu_torch.io.checkpoint import restore_checkpoint
from vinet_tpu_torch.io.weights import from_jax_trees
from vinet_tpu_torch.training.trainer import init_train_state

torch.set_num_threads(TORCH_THREADS)
SHAPE = (8, 8, 32, 32, 3)  # grad_accum 2's batch; the others take its first 4 rows
TOL = 1e-10


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jm = JaxViNet(3, 8)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    trees = (bn_tree(shapes[0], rng), bn_tree(shapes[1], rng))
    vinet8 = {"clip": rng.standard_normal(SHAPE).astype(np.float32),
              "gt": np.clip(rng.random(SHAPE[:1] + SHAPE[2:4]), 0.05, 1.0).astype(np.float32)}
    batches = {"vinet8": vinet8, "vinet4": {k: v[:4] for k, v in vinet8.items()},
               "fusion": av_batch(seed=1, b=2, hw=(64, 96), clip_size=8),
               "ct": {"clip": rng.standard_normal((4, 2, 8, 8, 3)).astype(np.float32),
                      "gt": np.clip(rng.random((4, 16, 16)), 0.05, 1.0).astype(np.float32)}}
    bn_inputs = {"bn3d": (rng.standard_normal((4, 6, 3, 5, 4)) * 2 + 1,
                          rng.standard_normal((4, 6, 3, 5, 4))),
                 "bn1d": (rng.standard_normal((4, 6, 50)) * 2 + 1,
                          rng.standard_normal((4, 6, 50)))}
    ckdir = tmp_path_factory.mktemp("ck")
    world = World(rank_train, 2, trees, batches, bn_inputs, str(ckdir),
                  workdir=tmp_path_factory.mktemp("world"))

    bn_refs = {}
    for name, (x, w) in bn_inputs.items():
        cls = torch.nn.BatchNorm3d if name == "bn3d" else torch.nn.BatchNorm1d
        bn = seeded_bn(cls(x.shape[1], eps=1e-3, momentum=0.1))
        xt = torch.from_numpy(x).requires_grad_()
        y = bn(xt)
        (y * torch.from_numpy(w)).sum().backward()
        bn_refs[name] = {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
                         "dweight": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
                         "running_mean": bn.running_mean.numpy(),
                         "running_var": bn.running_var.numpy()}
    sharding = NamedSharding(jax_create_mesh(jax.devices()[:2]), PartitionSpec("data"))
    _, jloss, jstate = jax_train_forward(jm)(*trees, batches["vinet4"], sharding)
    ref_ts, ref = float64_step(port_vinet(*trees), batches["vinet4"], 1, None)  # one process
    ref_opt = ref_ts.optimizer.state_dict()["state"]
    del ref_ts
    ranks = world.results()

    errs = {}  # rank 0's checkpoints at world 1 against one process's step
    for name in ("data2", "model2"):
        ts = init_train_state(port_vinet(*trees), 1e-4, seed=None)
        restore_checkpoint(str(ckdir / name), ts)
        opt = ts.optimizer.state_dict()["state"]
        state = {k: v.numpy() for k, v in ts.model.state_dict().items()}
        summary = ranks[0]["model2"] if name == "model2" else ranks[0]["data2"]["vinet_accum1"]
        errs[f"{name}_at_world1"] = {
            **step_errors({**summary, "state": state}, ref), "step": ts.step,
            "adam": max(rel_err(opt[i][k], v) for i, st in ref_opt.items()
                        for k, v in st.items())}
    shutil.rmtree(ckdir)
    return {"ranks": ranks, "bn_refs": bn_refs, "trees": trees, "errs": errs,
            "jax": (float(jloss), jstate)}


def _check_step(errs: dict) -> None:
    assert errs["same_keys"]
    assert errs["loss_err"] <= TOL and errs["grad_norm_err"] <= TOL, errs
    assert errs["state_err"] <= TOL, errs


def _same_on_both_ranks(r0: dict, r1: dict) -> None:
    assert (r0["loss"], r0["grad_norm"], r0["digest"]) == (r1["loss"], r1["grad_norm"],
                                                         r1["digest"])


@pytest.mark.parametrize("name", ["bn3d", "bn1d"])
def test_synced_batchnorm_equals_one_process(run, name):
    r0, r1 = (r["bn"][name] for r in run["ranks"])
    want = run["bn_refs"][name]
    for key in ("y", "dx"):
        assert rel_err(np.concatenate([r0[key], r1[key]]), want[key]) <= 1e-12, key
    for key in ("dweight", "dbias"):  # each rank's part; the train step sums them
        assert rel_err(r0[key] + r1[key], want[key]) <= 1e-12, key
    for key in ("running_mean", "running_var"):
        assert rel_err(r0[key], want[key]) <= 1e-12 and np.array_equal(r0[key], r1[key]), key


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_data_parallel_step_equals_one_process(run, name):
    _same_on_both_ranks(*(r["data2"][name] for r in run["ranks"]))
    ref_rank = TRAIN_CASES[name][3]
    _check_step(run["errs"]["data2_at_world1"] if ref_rank is None
                else run["ranks"][ref_rank]["data2"][name])


def test_model_axis_step_equals_one_process(run):
    r0, r1 = (r["model2"] for r in run["ranks"])
    _same_on_both_ranks(r0, r1)
    _check_step(run["errs"]["model2_at_world1"])
    for rank in (r0, r1):
        assert rank["shard_rows"]["backbone.base1.0.conv_s.weight"] == 32  # 64 out-channels
        assert "decoder.convtsp4.6.weight" not in rank["shard_rows"]  # conv7's one channel


def test_model_axis_shards_a_transposed_convolution_on_dim_1(run):
    r0, r1 = (r["ct_model2"] for r in run["ranks"])
    _same_on_both_ranks(r0, r1)
    _check_step(r0)
    assert r0["adam_err"] <= TOL, r0["adam_err"]
    for rank in (r0, r1):  # (I, O, kT, kH, kW) = (3, 4, 1, 4, 4): O split in 2
        assert rank["dims"] == {"ct.weight": 1, "bn.weight": 0, "bn.bias": 0}
        assert rank["shard_shapes"]["ct.weight"] == (3, 2, 1, 4, 4)


@pytest.mark.parametrize("name", ["data2", "model2"])
def test_checkpoint_loads_at_world_1(run, name):
    got = run["errs"][f"{name}_at_world1"]
    _check_step(got)
    assert got["step"] == 1 and got["adam"] <= TOL, got


def test_unsharded_checkpoint_loads_into_model_axis(run):
    for rank in run["ranks"]:
        got = rank["unsharded_into_model2"]
        assert got["step"] == 1 and got["sharded"] > 100, got
        assert got["shards"] == got["adam"] == 0.0, got


def test_data_parallel_step_matches_jax_on_a_data_mesh(run):
    jloss, jstate = run["jax"]
    got = run["ranks"][0]["jax_side"]
    assert abs(got["loss"] - jloss) / abs(jloss) <= 1e-5, (got["loss"], jloss)
    want = from_jax_trees(run["trees"][0], jstate)
    errs = {k: rel_err(got["stats"][k], want[k].numpy()) for k in got["stats"]}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])
