"""vinet_tpu_torch's audio-visual train step with the refinement encoder
and its eval step, against vinet_tpu's on the CPU, f32, dropout off. No JAX
training program is compiled: the step's loss and new BatchNorm statistics
come from the forward of JAX's ``make_train_step`` (its loss_fn,
``tests/torch_port_util.py::jax_train_forward``), the eval step from
``make_eval_step``; the encoder's gradients are held against JAX's in
``test_torch_av_training_grads.py``.

AViNet(3, 32, use_transformer) at 64 x 64, batch 2, seeded trees
(``tests/torch_port_util.py::av_bn_trees``).

- the train step: the loss within 1e-5 relative, the visual and SoundNet
  running statistics within 1e-5 of each tensor's largest value, the
  encoder's weights moved;
- the eval step (the port's ``predict``: eval mode, the decoder's folded
  tail and the head's plain version here, the fused kernel on a card): the
  maps within 2e-3 (the port's standing bound for AViNet's maps, the
  decoder's folded conv5 and the head against JAX's eval graph), loss, cc
  and sim within 1e-3 relative; the model's modes are restored.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_util import (TORCH_THREADS, av_batch, av_bn_trees, jax_train_forward,
                                   port_avinet, port_train_step, running_stats_err)
from vinet_tpu.training.losses import LossConfig as JaxLossConfig
from vinet_tpu.training.trainer import make_eval_step as jax_make_eval_step
from vinet_tpu_torch.training import LossConfig
from vinet_tpu_torch.training.trainer import init_train_state, make_eval_step

torch.set_num_threads(TORCH_THREADS)
HW = (64, 64)


@pytest.fixture(scope="module")
def setup():
    jm, params, state = av_bn_trees(True, input_hw=HW)
    return jm, params, state, av_batch(hw=HW), port_avinet(jm, params, state)


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_refinement_train_step_matches_jax(setup):
    jm, params, state, batch, model = setup
    _, jloss, jstate = jax_train_forward(jm)(params, state, batch)
    jloss = float(jloss)
    loss, trained = port_train_step(model, batch)
    errs = running_stats_err(trained, params, jstate)
    rel = abs(loss - jloss) / abs(jloss)
    print(f"use_transformer f32 loss rel err {rel:.3g}; BN statistics {errs}")
    assert rel <= 1e-5
    assert errs["visual"] <= 1e-5 and errs["audio"] <= 1e-5, errs
    assert not torch.equal(trained.transformer.transformer_encoder.layers[0].linear1.weight,
                           model.transformer.transformer_encoder.layers[0].linear1.weight)


def test_eval_step_matches_jax(setup):
    jm, params, state, batch, model = setup
    jm_metrics, jpred = jax_make_eval_step(jm, JaxLossConfig())(
        {"params": params, "state": state}, {k: jnp.asarray(v) for k, v in batch.items()})
    m = copy.deepcopy(model).train()
    metrics, pred = make_eval_step(LossConfig())(init_train_state(m), _torch(batch))
    assert m.training and all(mod.training for mod in m.modules())  # modes restored
    err = float(np.abs(pred.numpy() - np.asarray(jpred)).max())
    rel = {k: abs(float(metrics[k]) - float(jm_metrics[k])) / abs(float(jm_metrics[k]))
           for k in ("loss", "cc", "sim")}
    print(f"eval step: maps max |err| {err:.3g}; metrics rel err {rel}")
    assert pred.shape == (2, *HW) and err <= 2e-3
    assert max(rel.values()) <= 1e-3, rel
