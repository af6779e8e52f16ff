"""vinet_tpu_torch's AViNetFusion, TransformerDecoderLayer and
Seq2SeqTransformer against vinet_tpu's at f32 on the CPU, with the fusion's
weight bridge and export.

Trees: numpy-seeded over ``jax.eval_shape`` of each module's init
(``tests/torch_port_util.py::bn_tree``; LayerNorm scales 1 + N(0, 0.01));
AViNetFusion(clip_size=8, input_hw=(64, 96)): C 512, 6 video tokens and 3
audio tokens, a 9 x 512 table, batch 2.

- AViNetFusion's eval forward (the decoder's folded tail and the head's
  plain version here, the fused kernel on a card) and its train-mode
  forward (the decoder's plain graph, BatchNorm on batch statistics, no
  dropout), maps within 1e-5; its eval forward through ``make_inference_fn``
  with audio (BatchNorm folded) within 1e-5 of the unfolded one;
- TransformerDecoderLayer, and Seq2SeqTransformer's query decoder (all
  queries and query_idx 1) and spatial pre-encoder paths
  (``tests/test_completeness.py:59-83``), within 1e-5 of each output's
  largest value;
- the weight bridge: JAX trees -> the port's state_dict bit for bit, and
  the port's export -> JAX's ``torch_state_dict_to_trees`` -> the same
  trees bit for bit; the reference's names (``tests/torch_ref.py::
  TAViNetFusion``: Conv2d audio_conv_1x1, a top-level ``pe`` table) load
  strictly through ``load_weights`` with every tensor bit for bit, and the
  export loads strictly into TAViNetFusion with the table renamed, as
  ``tests/test_export.py`` loads JAX's.
"""

import copy
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_util import TORCH_THREADS, av_batch, av_bn_trees, bn_tree
from tests.torch_ref import TAViNetFusion
from vinet_tpu.io.convert import torch_state_dict_to_trees
from vinet_tpu.models.transformer import Seq2SeqTransformer as JaxSeq2Seq
from vinet_tpu.models.transformer import TransformerDecoderLayer as JaxDecoderLayer
from vinet_tpu_torch.io.export import export_torch_checkpoint
from vinet_tpu_torch.io.weights import from_jax_trees, load_weights, transformer_state_dict
from vinet_tpu_torch.models import AViNetFusion, Seq2SeqTransformer, TransformerDecoderLayer
from vinet_tpu_torch.models.inference import make_inference_fn

torch.set_num_threads(TORCH_THREADS)
HW = (64, 96)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def fusion():
    jm, params, state = av_bn_trees(fusion=True, input_hw=HW, clip_size=8)
    port = AViNetFusion(clip_size=8, input_hw=HW)
    port.load_state_dict(from_jax_trees(params, state, pe_len=port.tokens + 3), strict=True)
    return jm, params, state, port, av_batch(hw=HW, clip_size=8)


@pytest.mark.parametrize("train", [False, True])
def test_fusion_forward_matches_jax(fusion, train):
    jm, params, state, port, batch = fusion
    assert port.tokens == 6 and port.transformer.pos_encoder.pe.shape == (9, 1, 512)
    fwd = jax.jit(lambda p, s, x, a: jm.apply(p, s, x, a, train=train)[0])
    want = np.asarray(fwd(params, state, jnp.asarray(batch["clip"]), jnp.asarray(batch["audio"])))
    port = copy.deepcopy(port).train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(batch["clip"]), torch.from_numpy(batch["audio"])).numpy()
    err = float(np.abs(got - want).max())
    print(f"AViNetFusion train={train}: max |err| {err:.3g}")
    assert got.shape == (2, *HW) and err <= 1e-5


def test_fusion_inference_fn_with_audio(fusion):
    *_, port, batch = fusion
    clip, audio = torch.from_numpy(batch["clip"]), torch.from_numpy(batch["audio"])
    with torch.no_grad():
        want = copy.deepcopy(port).eval()(clip, audio)
    fn, folded = make_inference_fn(copy.deepcopy(port), dtype="float32", device="cpu")
    assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm) for m in folded.modules())
    assert float((fn(clip, audio) - want).abs().max()) <= 1e-5


def test_decoder_layer_matches_jax():
    layer = JaxDecoderLayer(16, 4, 24)
    params = bn_tree(jax.eval_shape(layer.init, jax.random.PRNGKey(0))[0],
                     np.random.default_rng(1))
    rng = np.random.default_rng(2)
    tgt, mem = (rng.standard_normal(s).astype(np.float32) for s in ((2, 3, 16), (2, 6, 16)))
    want = np.asarray(layer.apply(params, {}, jnp.asarray(tgt), jnp.asarray(mem))[0])
    port = TransformerDecoderLayer(16, 4, 24).eval()
    port.load_state_dict(transformer_state_dict(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(tgt), torch.from_numpy(mem)).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("kw, query_idx, out_shape", [
    (dict(num_encoder_layers=2, max_len=6, num_decoder_layers=2, num_queries=4), -1, (2, 4, 16)),
    (dict(num_encoder_layers=2, max_len=6, num_decoder_layers=2, num_queries=4), 1, (2, 1, 16)),
    (dict(num_encoder_layers=1, max_len=8, spatial_dim=8), -1, (2, 8, 16)),
], ids=["decoder", "decoder_query_idx", "spatial"])
def test_seq2seq_matches_jax(kw, query_idx, out_shape):
    tr = JaxSeq2Seq(feat_size=16, hidden_size=16, nhead=4, **kw)
    params = bn_tree(jax.eval_shape(tr.init, jax.random.PRNGKey(0))[0], np.random.default_rng(3))
    x = np.random.default_rng(4).standard_normal((2, kw["max_len"], 16)).astype(np.float32)
    want = np.asarray(tr.apply(params, {}, jnp.asarray(x), query_idx=query_idx)[0])
    port = Seq2SeqTransformer(16, 16, 4, **kw).eval()
    sd = transformer_state_dict(params)
    sd["pos_encoder.pe"] = port.pos_encoder.pe
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), query_idx=query_idx).numpy()
    assert got.shape == want.shape == out_shape
    assert _rel(got, want) <= 1e-5


def test_weight_bridge_and_export_roundtrip(fusion):
    jm, params, state, port, _ = fusion
    sd = from_jax_trees(params, state, pe_len=9)
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k]), k
    buf = io.BytesIO()
    export_torch_checkpoint(buf, port)
    buf.seek(0)
    exported = torch.load(buf, weights_only=True)
    assert exported["audio_conv_1x1.weight"].shape == (512, 1024, 1, 1)
    p2, s2 = torch_state_dict_to_trees(exported, has_conv6=False)  # the clip-8 decoder
    for tree, back in ((params, p2), (state, s2)):
        flat, flat_back = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (tree, back))
        assert [k for k, _ in flat] == [k for k, _ in flat_back]
        for (k, a), (_, b) in zip(flat, flat_back):
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


def test_reference_names_load_and_export_strict_loads_into_the_twin(tmp_path):
    torch.manual_seed(5)
    twin = TAViNetFusion()
    for mod in twin.modules():
        if isinstance(mod, (torch.nn.BatchNorm3d, torch.nn.BatchNorm2d)):
            mod.running_mean.data.normal_(0, 0.05)
            mod.running_var.data.uniform_(0.8, 1.2)
    torch.save(twin.state_dict(), tmp_path / "twin.pt")
    port = AViNetFusion()
    port.load_state_dict(load_weights(str(tmp_path / "twin.pt")), strict=True)
    ours = port.state_dict()
    for k, v in twin.state_dict().items():
        name = "transformer.pos_encoder.pe" if k == "pe" else k
        assert torch.equal(ours[name].reshape(v.shape), v), k
    assert float((port.transformer.pos_encoder.pe - twin.pe).abs().max()) <= 1e-6

    export_torch_checkpoint(str(tmp_path / "port.pt"), port)
    sd = torch.load(str(tmp_path / "port.pt"), weights_only=True)
    sd["pe"] = sd.pop("transformer.pos_encoder.pe")
    TAViNetFusion().load_state_dict(sd, strict=True)
