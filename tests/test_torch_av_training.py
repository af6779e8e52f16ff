"""vinet_tpu_torch's audio-visual train step against vinet_tpu's
``make_train_step`` in f32 on the CPU, dropout off (a JAX state without
"rng", a port state without a dropout seed), one JAX training program
compiled. The bf16 step, the fixture's trees, grad_accum, the gradients,
the refinement encoder's step, the eval step and BN recalibration are in
``test_torch_av_training_{bf16,grads,eval}.py``.

AViNet(3, 32) at 64 x 64 (y0 (4, 2, 2): 2 pooled features, 16 tokens),
batch 2, seeded trees (``tests/torch_port_util.py::av_bn_trees``, every
leaf from numpy), the same numpy batch for both packages (``av_batch``);
64 x 64, the size at which the port's bf16 backward runs on the CPU
(``test_torch_av_training_bf16.py``). The f32 loss within 1e-5 relative,
every BatchNorm's new running statistics, the visual net's (momentum
0.001) and SoundNet's (momentum 0.1), within 1e-5 of each tensor's largest
value.
"""

import torch

from tests.torch_port_util import (TORCH_THREADS, av_batch, av_bn_trees, jax_train_step_fn,
                                   port_avinet, port_train_step, running_stats_err)

torch.set_num_threads(TORCH_THREADS)
HW = (64, 64)


def test_f32_train_step_loss_and_bn_statistics_match_jax():
    jm, params, state = av_bn_trees(False, input_hw=HW)
    batch = av_batch(hw=HW)
    model = port_avinet(jm, params, state)
    jloss, jstate = jax_train_step_fn(jm)(params, state, batch)
    loss, trained = port_train_step(model, batch)
    errs = running_stats_err(trained, params, jstate)
    rel = abs(loss - jloss) / abs(jloss)
    print(f"f32 loss {loss:.7g} vs JAX {jloss:.7g} (rel {rel:.3g}); BN statistics "
          f"visual {errs['visual']:.3g}, SoundNet {errs['audio']:.3g}")
    assert rel <= 1e-5
    assert errs["visual"] <= 1e-5 and errs["audio"] <= 1e-5, errs
    # SoundNet's statistics move at momentum 0.1, the visual net's at 0.001
    assert not torch.equal(trained.audionet.batchnorm1.running_mean,
                           model.audionet.batchnorm1.running_mean)
