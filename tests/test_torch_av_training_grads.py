"""vinet_tpu_torch's audio-visual gradients and BatchNorm recalibration with
audio against JAX's on the CPU.

Gradients: AViNet with the refinement encoder (the bilinear fusion,
SoundNet, conv_in_1x1, the encoder's three layers, conv_out_1x1 and the
decoder), every BatchNorm frozen (the backbone's and SoundNet's in eval
mode), the decoder on its training graph, the encoder in training mode
without dropout. One JAX training program is compiled:
``jax.value_and_grad`` of the same forward, written out of
``vinet_tpu/models/avinet.py::AViNet.apply`` with ``train=False`` for the
BatchNorms.

Train-mode BatchNorm after every conv makes a whole-model f32 gradient
chaotic (``test_torch_training.py``), and the CPU's f32 conv backward
rounds more than XLA's, so the port's gradients are taken in float64: every
leaf's gradient within 2e-4 of the leaf's largest value from JAX's f32
gradient, the loss within 1e-5 relative (l1 in the loss, so that conv7's
bias gradient is not a sum that cancels).

BatchNorm statistics with audio (``make_bn_stats_fn``) and
``recalibrate_bn`` over two batches of one clip, against JAX's
``recalibrate_bn`` (a forward program), every BatchNorm's (the visual net's
and SoundNet's), with the port's own float64 recalibration as the arbiter:
the port's f32 lies within 1e-5 of it or no further than JAX's f32 does, and
JAX's within 5e-3 (each tensor's max |err| relative to its largest value,
the worst tensor of each part). Statistics taken directly from one clip's
batch, without momentum's dilution, carry the f32 rounding of every
train-mode BatchNorm before them: at the deepest layers (16 values a
channel) the port's f32 lies 1.1e-4 from float64 and JAX's 9.5e-4 (its
one-pass batch variance). The parameters and the modes are left as they
were.

AViNet(3, 32, use_transformer) at 64 x 64, batch 2, seeded trees
(``tests/torch_port_util.py::av_bn_trees``).
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_util import TORCH_THREADS, av_batch, av_bn_trees, port_avinet
from vinet_tpu.models.avinet import _ndhwc_from_tokens, _tokens_from_ndhwc
from vinet_tpu.ops.conv import maxpool3d
from vinet_tpu.training.losses import LossConfig as JaxLossConfig
from vinet_tpu.training.losses import loss_func as jax_loss_func
from vinet_tpu.training.trainer import make_bn_stats_fn as jax_make_bn_stats_fn
from vinet_tpu.training.trainer import recalibrate_bn as jax_recalibrate_bn
from vinet_tpu_torch.io.weights import from_jax_trees
from vinet_tpu_torch.training import LossConfig, loss_func
from vinet_tpu_torch.training.trainer import make_bn_stats_fn, recalibrate_bn

torch.set_num_threads(TORCH_THREADS)
HW = (64, 64)
CFG = dict(kldiv=True, l1=True)


def jax_frozen_bn_forward(jm, p, state, clip, audio):
    """AViNet.apply with train=False for SoundNet and the backbone (running
    statistics), the encoder in training mode without a key, and
    train=True for the decoder."""
    a, _ = jm.audionet.apply(p["audionet"], state["audionet"], audio)
    (y0, y1, y2, y3), _ = jm.visual.backbone.apply(p["visual_model"]["backbone"],
                                                   state["visual_model"]["backbone"], clip)
    y0p = maxpool3d(y0, kernel=(4, 1, 1), stride=(2, 1, 2), padding=0)
    fused, _ = jm.bilinear.apply(p["bilinear"], {}, _tokens_from_ndhwc(y0p),
                                 jnp.swapaxes(a, 1, 2))
    fused = _ndhwc_from_tokens(fused, jm.y0_tdhw)
    cin, tr, cout = jm._refiner()
    z, _ = cin.apply(p["conv_in_1x1"], {}, fused)
    tokens, _ = tr.apply(p["transformer"], {}, _tokens_from_ndhwc(z), train=True)
    fused, _ = cout.apply(p["conv_out_1x1"], {}, _ndhwc_from_tokens(tokens, jm.y0_tdhw))
    out, _ = jm.visual.decoder.apply(p["visual_model"]["decoder"], {}, [fused, y1, y2, y3],
                                     train=True)
    return out


def test_frozen_bn_gradients_match_jax():
    jm, params, state = av_bn_trees(True, input_hw=HW)
    batch = av_batch(hw=HW)

    def loss_fn(p, clip, audio, gt):
        out = jax_frozen_bn_forward(jm, p, state, clip, audio)
        return jax_loss_func(out, gt, JaxLossConfig(**CFG))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(
        params, *(jnp.asarray(batch[k]) for k in ("clip", "audio", "gt")))
    want = from_jax_trees(jax.tree_util.tree_map(np.asarray, jg), state)

    model = port_avinet(jm, params, state)
    losses, errs = {}, {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(model).to(dtype).train()
        for bn in m.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                bn.eval()
        t = {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()}
        loss = loss_func(m(t["clip"], t["audio"]), t["gt"], LossConfig(**CFG))
        loss.backward()
        losses[dtype] = abs(float(loss.detach()) - float(jl)) / abs(float(jl))
        grads = {k: p.grad.double() for k, p in m.named_parameters() if p.grad is not None}
        errs[dtype] = {k: float((g - want[k].double()).abs().max() / want[k].double().abs().max())
                       for k, g in grads.items()}
    assert {k.split(".")[0] for k in errs[torch.float64]} == {
        "visual_model", "audionet", "bilinear", "conv_in_1x1", "transformer", "conv_out_1x1"}
    worst = max(errs[torch.float64], key=errs[torch.float64].get)
    print(f"loss rel err f32 {losses[torch.float32]:.3g}; JAX f32 gradients from the port's "
          f"float64: worst leaf {worst} {errs[torch.float64][worst]:.3g}; from the port's f32: "
          f"{max(errs[torch.float32].values()):.3g}")
    assert losses[torch.float32] <= 1e-5, losses
    assert errs[torch.float64][worst] <= 2e-4, (worst, errs[torch.float64][worst])


def test_bn_statistics_and_recalibration_with_audio_match_jax():
    jm, params, state = av_bn_trees(True, input_hw=HW)
    batch, model = av_batch(hw=HW), port_avinet(jm, params, state)
    halves = [{k: v[i:i + 1] for k, v in batch.items() if k != "gt"} for i in range(2)]
    jstate = jax_recalibrate_bn(jm, params, state,
                                ({k: jnp.asarray(v) for k, v in h.items()} for h in halves),
                                stats_fn=jax_make_bn_stats_fn(jm))
    want = from_jax_trees(params, jax.tree_util.tree_map(np.asarray, jstate))
    recalibrated = {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(model).to(dtype).eval()
        before = {k: v.clone() for k, v in m.state_dict().items()}
        stats_fn = make_bn_stats_fn(m)
        one = stats_fn(*(torch.from_numpy(halves[0][k]).to(dtype) for k in ("clip", "audio")))
        assert "audionet.batchnorm7" in one and all(torch.equal(v, before[k])
                                                    for k, v in m.state_dict().items())
        recalibrate_bn(m, [{k: torch.from_numpy(v).to(dtype) for k, v in h.items()}
                           for h in halves], stats_fn=stats_fn)
        assert not any(mod.training for mod in m.modules())
        assert all(bn.momentum == (0.1 if name.startswith("audionet.") else 0.001)
                   for name, bn in m.named_modules()
                   if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm))
        for k, v in m.state_dict().items():
            if "running" not in k:
                assert torch.equal(v, before[k]), k
        recalibrated[dtype] = m.state_dict()

    exact = recalibrated[torch.float64]

    def worst(stats) -> dict:
        errs = {"visual": 0.0, "audio": 0.0}
        for k, v in exact.items():
            if "running" in k:
                part = "audio" if k.startswith("audionet.") else "visual"
                e = float((stats[k].double() - v).abs().max() / v.abs().max())
                errs[part] = max(errs[part], e)
        return errs

    port, ref = worst(recalibrated[torch.float32]), worst(want)
    print(f"recalibrated statistics from the port's float64: port f32 {port}, JAX f32 {ref}")
    for part in ("visual", "audio"):
        assert port[part] <= max(ref[part], 1e-5) and ref[part] <= 5e-3, (part, port, ref)
