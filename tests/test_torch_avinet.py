"""vinet_tpu_torch's audio-visual model (SoundNet, Bilinear, the refinement
encoder, AViNet), its inference preparation and its weight bridge, against
vinet_tpu on the same numpy inputs and trees, f32 on the CPU.

The trees: AViNet(3, 32) at 64 x 96 (y0 (4, 2, 3): 4 pooled features, 24
tokens), the visual leaves from the committed fixture, the audio and fusion
leaves from numpy (``tests/torch_port_util.py::av_trees``, the card's
seeding; JAX's init is never called). The JAX forward is jitted with the
trees as arguments.

Tolerances: SoundNet 1e-5 of its output's max, folded and unfolded;
Bilinear 1e-6; the sin/cos table 1e-7; one encoder layer and the stack of 3
1e-5; AViNet maps 2e-3 (the port's standing bound), bf16 against JAX bf16
2e-2; the weight bridge bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_util import TORCH_THREADS, av_trees, port_avinet
from tests.torch_ref import TSoundNet
from vinet_tpu.io.convert import torch_state_dict_to_trees
from vinet_tpu.io.export import _model_pe_tables, trees_to_torch_state_dict
from vinet_tpu.models import Bilinear as JaxBilinear
from vinet_tpu.models import SoundNet as JaxSoundNet
from vinet_tpu.models.inference import fold_batchnorms as jax_fold
from vinet_tpu.models.transformer import TransformerEncoder as JaxEncoder
from vinet_tpu.models.transformer import TransformerEncoderLayer as JaxLayer
from vinet_tpu.models.transformer import positional_encoding as jax_pe
from vinet_tpu_torch.inference.accuracy import seeded_av_leaves
from vinet_tpu_torch.io.export import export_torch_checkpoint
from vinet_tpu_torch.io.weights import from_jax_trees, load_model_weights, load_weights
from vinet_tpu_torch.models import AViNet, Bilinear, SoundNet, TransformerEncoder, fold_batchnorms
from vinet_tpu_torch.models.inference import make_inference_fn
from vinet_tpu_torch.models.transformer import TransformerEncoderLayer, positional_encoding

torch.set_num_threads(TORCH_THREADS)
TOL = 2e-3
L = 70560  # samples of an excerpt


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _audio(b, seed):
    return (np.random.default_rng(seed).standard_normal((b, L, 1)) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    return {ut: av_trees(ut) for ut in (False, True)}


@pytest.mark.parametrize("folded", [False, True])
def test_soundnet_matches_jax(trees, folded):
    """(2, 70560, 1) -> (2, 3, 1024) against JAX's SoundNet, BatchNorm
    (eps 1e-5) folded on both sides or applied on both."""
    _, params, state = trees[False]
    p, s = params["audionet"], state["audionet"]
    port = port_avinet(*trees[False]).audionet
    if folded:
        p, s = jax_fold(p, s)
        fold_batchnorms(port)
        assert not any(isinstance(m, torch.nn.BatchNorm1d) for m in port.modules())
    x = _audio(2, 1)
    want = np.asarray(jax.jit(lambda p, s, x: JaxSoundNet().apply(p, s, x)[0])(p, s, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).reshape(2, 1, L)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, 3, 1024)
    rel = _err(got, want) / np.abs(want).max()
    print(f"SoundNet folded={folded}: max|err| / max {rel:.3g}")
    assert rel <= 1e-5


def test_soundnet_lengths_and_reference_conv2d_form(tmp_path):
    """The plan's lengths, 70560 -> 35281 -> 4410 -> 2206 -> 275 -> 138 ->
    70 -> 36 -> 9 -> 5 -> 3, and the port's SoundNet = the reference's
    Conv2d-(k, 1) SoundNet (``tests/torch_ref.py::TSoundNet``) on a state_dict
    of it loaded through load_weights."""
    torch.manual_seed(0)
    ref = TSoundNet().eval()
    for name, buf in ref.named_buffers():
        if name.endswith("running_var"):
            buf.uniform_(0.5, 1.5)
    path = str(tmp_path / "soundnet.pth")
    torch.save(ref.state_dict(), path)
    port = SoundNet().eval()
    port.load_state_dict({k[len("audionet."):]: v for k, v in load_weights(path).items()},
                         strict=True)
    lengths = []
    for m in port.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.MaxPool1d)) and m not in (
                port.conv8_objs, port.conv8_scns):
            m.register_forward_hook(lambda mod, i, o: lengths.append(o.shape[-1]))
    x = torch.from_numpy(_audio(1, 2)).reshape(1, 1, L)
    with torch.no_grad():
        got = port(x)
        want = ref(x.reshape(1, 1, L, 1))[..., 0]
    assert lengths == [35281, 4410, 2206, 275, 138, 70, 36, 9, 5, 3]
    assert _err(got, want) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_matches_jax(dtype):
    """f32 within 1e-6; bf16 in, f32 accumulation and bias, one bf16
    rounding out: within one bf16 step of the f32 result."""
    rng = np.random.default_rng(3)
    x1 = rng.standard_normal((2, 16, 4)).astype(np.float32)
    x2 = rng.standard_normal((2, 16, 3)).astype(np.float32)
    w = (rng.standard_normal((24, 4, 3)) / np.sqrt(12)).astype(np.float32)
    b = (rng.standard_normal(24) * 0.1).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    want = JaxBilinear(4, 3, 24).apply({"w": jnp.asarray(w), "b": jnp.asarray(b)}, {},
                                       jnp.asarray(x1, jd), jnp.asarray(x2, jd))[0]
    port = Bilinear(4, 3, 24)
    port.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    port = port.to(td)
    with torch.no_grad():
        got = port(torch.from_numpy(x1).to(td), torch.from_numpy(x2).to(td))
    assert got.dtype == td and tuple(got.shape) == want.shape == (2, 16, 24)
    err = _err(got.float(), np.asarray(want, np.float32))
    print(f"Bilinear {dtype}: max|err| {err:.3g}")
    assert err <= (1e-6 if dtype == "float32" else 2 ** -7 * np.abs(np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("max_len,feat", [(32, 336), (339, 512), (5, 7)])
def test_positional_encoding_matches_jax(max_len, feat):
    got = positional_encoding(max_len, feat).numpy()
    assert got.shape == (max_len, feat) and _err(got, jax_pe(max_len, feat)) <= 1e-7


def test_encoder_layer_and_stack_match_jax(trees):
    """AViNet's refiner geometry at full width (E 336, 4 heads of 84, hidden
    336, S = 32 tokens): one layer, and the stack of 3 with the table."""
    e = 336
    x = (np.random.default_rng(4).standard_normal((2, 32, e))).astype(np.float32)
    port = TransformerEncoder(e, 4, 3, hidden_size=e, max_len=32).eval()
    seeded = {**port.state_dict(), **seeded_av_leaves(port, 5)}
    full = torch_state_dict_to_trees({f"transformer.{k}": v for k, v in seeded.items()})[0]
    full = full["transformer"]
    shapes = jax.eval_shape(JaxEncoder(e, 4, 3, hidden_size=e, max_len=32).init,
                            jax.random.PRNGKey(0))[0]
    assert jax.tree.map(np.shape, full) == jax.tree.map(lambda s: s.shape, shapes)
    assert set(full) == set(trees[True][1]["transformer"]) == {"layers"}
    sd = from_jax_trees({"transformer": full, "conv_in_1x1": {"w": np.zeros((1, 1, 1, 1, 32))}},
                        {})
    port.load_state_dict({k[len("transformer."):]: v for k, v in sd.items()
                          if k.startswith("transformer.")}, strict=True)
    layer0 = TransformerEncoderLayer(e, 4, e).eval()
    layer0.load_state_dict(port.transformer_encoder.layers[0].state_dict())
    want1 = JaxLayer(e, 4, e).apply(full["layers"]["0"], {}, jnp.asarray(x))[0]
    want3 = JaxEncoder(e, 4, 3, hidden_size=e, max_len=32).apply(full, {}, jnp.asarray(x))[0]
    with torch.no_grad():
        got1 = layer0(torch.from_numpy(x))
        got3 = port(torch.from_numpy(x))
    print(f"layer {_err(got1, want1):.3g}, stack {_err(got3, want3):.3g}")
    assert _err(got1, want1) <= 1e-5 and _err(got3, want3) <= 1e-5


def _jax_maps(model, params, state, x, a, dtype=jnp.float32, fold=False):
    """JAX's maps, the trees folded (``fold_batchnorms``) and cast inside the
    jitted function (eagerly, the full tree's fold takes seconds)."""
    from vinet_tpu.models.inference import cast_floating

    def run(p, s, x, a):
        if fold:
            p, s = jax_fold(p, s)
        p, s = cast_floating(p, dtype), cast_floating(s, dtype)
        return model.apply(p, s, x.astype(dtype), a.astype(dtype))[0]

    return np.asarray(jax.jit(run)(params, state, jnp.asarray(x), jnp.asarray(a)), np.float32)


@pytest.fixture(scope="module")
def inputs():
    from tests.torch_port_util import normalized_clip

    return normalized_clip(6, (2, 32, 64, 96, 3)), _audio(2, 7)


@pytest.mark.parametrize("use_transformer", [False, True])
def test_avinet_matches_jax(trees, inputs, use_transformer):
    """Maps of the JAX AViNet (its default, phase-folded tail) and the port's
    (BatchNorm unfolded, the head's fused plain version), f32."""
    model, params, state = trees[use_transformer]
    x, a = inputs
    want = _jax_maps(model, params, state, x, a)
    port = port_avinet(model, params, state)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    assert got.shape == want.shape == (2, 64, 96)
    print(f"use_transformer={use_transformer}: max|err| {_err(got, want):.3g}")
    assert _err(got, want) < TOL


def test_bf16_avinet_matches_jax_bf16(trees, inputs):
    """make_inference_fn (BatchNorm folded, bf16) with audio against JAX's
    bf16 forward on its folded trees."""
    model, params, state = trees[True]
    x, a = (v[:1] for v in inputs)  # one clip: XLA's CPU bf16 convs are slow
    want = _jax_maps(model, params, state, x, a, jnp.bfloat16, fold=True)
    fn, prepared = make_inference_fn(port_avinet(model, params, state), dtype="bfloat16",
                                     device="cpu")
    assert prepared.bilinear.weight.dtype == torch.bfloat16
    assert prepared.transformer.pos_encoder.pe.dtype == torch.bfloat16
    assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                   for m in prepared.modules())
    got = fn(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    print(f"bf16: max|err| {_err(got, want):.3g}")
    assert got.dtype == np.float32 and _err(got, want) <= 2e-2


def test_int8_refuses_avinet(trees):
    with pytest.raises(ValueError, match="visual ViNet only"):
        make_inference_fn(port_avinet(*trees[False]), dtype="int8", device="cpu",
                          calib_clips=torch.zeros(1))


@pytest.mark.parametrize("use_transformer", [False, True])
def test_weight_bridge_round_trip(trees, use_transformer, tmp_path):
    """JAX trees -> the port (strict) -> export -> load_weights -> the port:
    bit for bit; the export equals the JAX package's
    trees_to_torch_state_dict with its synthesized sin/cos table, key for
    key and value for value (SoundNet's convs as Conv2d (O, I, k, 1))."""
    model, params, state = trees[use_transformer]
    port = port_avinet(model, params, state)
    out = str(tmp_path / "avinet.pt")
    export_torch_checkpoint(out, port)
    want = trees_to_torch_state_dict(params, state, pe_tables=_model_pe_tables(model, params))
    got = torch.load(out, weights_only=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and np.array_equal(got[k].numpy(), v), k
    assert got["audionet.conv1.weight"].shape == (16, 1, 64, 1)
    again = port_avinet(model, params, state)
    for t in again.parameters():
        t.data.zero_()
    again.load_state_dict(load_weights(out), strict=True)
    for (k, a), (_, b) in zip(port.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k


def test_soundnet_file_loads_into_audionet_alone(tmp_path):
    """A SoundNet-only state_dict (soundnet8_final.pth's names, Conv2d
    weights) loads into AViNet's audionet alone; the rest keeps its weights."""
    torch.manual_seed(1)
    ref = TSoundNet()
    path = str(tmp_path / "soundnet8_final.pth")
    torch.save(ref.state_dict(), path)
    model = AViNet(input_hw=(64, 96))
    before = model.bilinear.weight.clone()
    load_model_weights(model, path)
    assert torch.equal(model.audionet.conv7.weight, ref.conv7.weight[..., 0])
    assert torch.equal(model.audionet.batchnorm3.running_var, ref.batchnorm3.running_var)
    assert torch.equal(model.bilinear.weight, before)
