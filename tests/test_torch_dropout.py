"""Dropout in vinet_tpu_torch's training, the port's counterparts of
``tests/test_dropout_rng.py`` on the port's AViNetFusion(clip_size=8,
input_hw=(64, 96)) (a seeded random init, batch 2, on the CPU), and the
mechanism itself:

  (a) at lr 0 the train-mode losses differ from step to step (the masks
      follow the step);
  (b) a state without a dropout seed trains deterministically and stays
      without one;
  (c) the same step from the same state reproduces its loss exactly;
  (d) a checkpoint restores the seed, and the resumed step's loss equals
      the unbroken run's exactly;
  (e) the keep rate is 0.9 within 0.002 over 10^6 draws, kept elements
      scaled by exactly 1 / 0.9;
  (f) an encoder layer drops at JAX's three sites (the attention
      probabilities, the attention output, the feed-forward output) and a
      decoder layer at its three (the self- and cross-attention
      probabilities, the feed-forward output), in that order: the layer's
      output equals, within 1e-6, the layer recomputed by hand with masks
      drawn from an identically seeded generator at those sites alone;
  (g) nothing is drawn in eval mode or without a generator, and a train
      step never draws from the global RNG.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_port_util import TORCH_THREADS
from vinet_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint
from vinet_tpu_torch.models import AViNetFusion, TransformerDecoderLayer, TransformerEncoderLayer
from vinet_tpu_torch.models.transformer import dropout
from vinet_tpu_torch.training import LossConfig
from vinet_tpu_torch.training.trainer import init_train_state, make_train_step

torch.set_num_threads(TORCH_THREADS)
P = 0.1


@pytest.fixture(scope="module")
def fusion_setup():
    torch.manual_seed(0)
    model = AViNetFusion(clip_size=8, input_hw=(64, 96))
    rng = np.random.default_rng(1)
    batch = {"clip": torch.from_numpy(rng.standard_normal((2, 8, 64, 96, 3)).astype(np.float32)),
             "gt": torch.from_numpy(np.clip(rng.random((2, 64, 96)), 0.05, 1.0).astype(np.float32)),
             "audio": torch.from_numpy((0.1 * rng.standard_normal((2, 70560, 1))).astype(np.float32))}
    return model, batch, make_train_step(LossConfig())


def _state(model, seed=0):
    # lr 0 freezes the parameters: a loss that changes is dropout alone
    return init_train_state(copy.deepcopy(model), 0.0, seed=seed)


def test_dropout_varies_across_steps(fusion_setup):
    model, batch, step = fusion_setup
    ts = _state(model)
    l1, l2 = (float(step(ts, batch)[1]["loss"]) for _ in range(2))
    assert np.isfinite([l1, l2]).all() and l1 != l2, (l1, l2)


def test_no_seed_is_deterministic(fusion_setup):
    model, batch, step = fusion_setup
    ts = _state(model, seed=None)
    l1, l2 = (float(step(ts, batch)[1]["loss"]) for _ in range(2))
    assert ts.dropout_seed is None and ts.step == 2
    assert l1 == l2


def test_same_step_same_seed_reproduces(fusion_setup):
    model, batch, step = fusion_setup
    ts = _state(model)
    la = float(step(copy.deepcopy(ts), batch)[1]["loss"])
    lb = float(step(copy.deepcopy(ts), batch)[1]["loss"])
    assert la == lb


def test_resume_restores_dropout_stream(fusion_setup, tmp_path):
    model, batch, step = fusion_setup
    ts = _state(model, seed=5)
    step(ts, batch)
    save_checkpoint(str(tmp_path / "ckpt"), ts)
    restored = restore_checkpoint(str(tmp_path / "ckpt"), _state(model, seed=9))
    assert restored.step == 1 and restored.dropout_seed == 5
    direct = float(step(ts, batch)[1]["loss"])
    resumed = float(step(restored, batch)[1]["loss"])
    assert direct == resumed


def test_keep_rate_and_scale():
    g = torch.Generator().manual_seed(0)
    out = dropout(torch.ones(10 ** 6), P, g)
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - P)) <= 0.002
    assert torch.equal(out[kept], torch.full((int(kept.sum()),), 1.0) / (1 - P))
    x = torch.randn(100)
    assert dropout(x, P, None) is x and dropout(x, 0.0, g) is x


def _masked(x, g):
    keep = torch.rand(x.shape, generator=g) < 1 - P
    return torch.where(keep, x / (1 - P), torch.zeros(()))


def _attention(attn_mod, q_in, kv_in, g):
    """The layer's attention by hand, the probabilities dropped."""
    e, h = q_in.shape[-1], attn_mod.nhead
    w, b = attn_mod.in_proj_weight, attn_mod.in_proj_bias
    heads = lambda t: t.reshape(*t.shape[:2], h, e // h).transpose(1, 2)
    q = heads(F.linear(q_in, w[:e], b[:e]))
    k = heads(F.linear(kv_in, w[e:2 * e], b[e:2 * e]))
    v = heads(F.linear(kv_in, w[2 * e:], b[2 * e:]))
    attn = _masked(torch.softmax(q @ k.transpose(-1, -2) / (e // h) ** 0.5, -1), g)
    return attn_mod.out_proj((attn @ v).transpose(1, 2).reshape(q_in.shape))


def test_encoder_layer_drops_at_jax_three_sites():
    torch.manual_seed(2)
    layer = TransformerEncoderLayer(16, 4, 24).train()
    x = torch.randn(2, 6, 16)
    with torch.no_grad():
        got = layer(x, torch.Generator().manual_seed(3))
        g = torch.Generator().manual_seed(3)
        y = layer.norm1(x + _masked(_attention(layer.self_attn, x, x, g), g))
        want = layer.norm2(y + _masked(layer.linear2(torch.relu(layer.linear1(y))), g))
    assert float((got - want).abs().max()) <= 1e-6
    assert not torch.allclose(got, layer(x), atol=1e-3)  # something was dropped


def test_decoder_layer_drops_at_jax_three_sites():
    torch.manual_seed(4)
    layer = TransformerDecoderLayer(16, 4, 24).train()
    tgt, mem = torch.randn(2, 3, 16), torch.randn(2, 6, 16)
    with torch.no_grad():
        got = layer(tgt, mem, torch.Generator().manual_seed(5))
        g = torch.Generator().manual_seed(5)
        t = layer.norm1(tgt + _attention(layer.self_attn, tgt, tgt, g))
        t = layer.norm2(t + _attention(layer.multihead_attn, t, mem, g))
        want = layer.norm3(t + _masked(layer.linear2(torch.relu(layer.linear1(t))), g))
    assert float((got - want).abs().max()) <= 1e-6
    assert not torch.allclose(got, layer(tgt, mem), atol=1e-3)


def test_nothing_is_drawn_in_eval_mode_or_from_the_global_rng(fusion_setup):
    model, batch, step = fusion_setup
    layer = TransformerEncoderLayer(16, 4, 24).eval()
    g, x = torch.Generator().manual_seed(6), torch.randn(2, 6, 16)
    before = g.get_state()
    with torch.no_grad():
        assert torch.equal(layer(x, g), layer(x))
    assert torch.equal(g.get_state(), before)

    m = copy.deepcopy(model).eval()
    with torch.no_grad():
        out = m(batch["clip"], batch["audio"], g)
        assert torch.equal(out, m(batch["clip"], batch["audio"]))
    assert torch.equal(g.get_state(), before)

    rng = torch.get_rng_state()
    step(_state(model), batch)
    assert torch.equal(torch.get_rng_state(), rng)
