"""vinet_tpu_torch's weight bridge, S3D backbone and decoder against
vinet_tpu, with the committed full-width ViNet(3, 32) fixture weights at f32
on a (1, 32, 32, 32, 3) clip.

Tolerance: max|err| < 2e-3, the full-model parity anchor of the JAX package's
torch-conversion tests (NOTES.md "Parity status").
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_util import (FIXTURE, TORCH_THREADS, fixture_trees, ncdhw_to_ndhwc,
                                   ndhwc_to_ncdhw)
from vinet_tpu.data.pipeline import device_preprocess as jax_device_preprocess
from vinet_tpu.io.export import export_torch_checkpoint, trees_to_torch_state_dict
from vinet_tpu.models import Decoder as JaxDecoder
from vinet_tpu.models import S3DBackbone as JaxS3D
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu.models import decoder_plan as jax_decoder_plan
from vinet_tpu_torch.io.weights import from_jax_trees, load_weights
from vinet_tpu_torch.models import DECODER_PLANS, ViNet
from vinet_tpu_torch.ops import saliency_head as head

torch.set_num_threads(TORCH_THREADS)
TOL = 2e-3


@pytest.fixture(scope="module")
def trees():
    return fixture_trees()


@pytest.fixture(scope="module")
def clip():
    u8 = np.random.default_rng(0).integers(0, 256, (1, 32, 32, 32, 3), dtype=np.uint8)
    return np.asarray(jax_device_preprocess(jnp.asarray(u8)))


@pytest.fixture(scope="module")
def port_model(trees):
    model = ViNet(3, 32)
    model.load_state_dict(from_jax_trees(*trees), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def jax_pyramid(trees, clip):
    params, state = trees
    pyr, _ = JaxS3D().apply(params["backbone"], state["backbone"], jnp.asarray(clip))
    return [np.asarray(y) for y in pyr]


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_from_jax_trees_names_and_strict_load(trees):
    params, state = trees
    sd = from_jax_trees(params, state)
    assert set(sd) == set(trees_to_torch_state_dict(params, state))
    assert set(sd) == set(ViNet(3, 32).state_dict())
    ViNet(3, 32).load_state_dict(sd, strict=True)
    w = params["decoder"]["conv6"]["w"]  # (kt, 1, 1, I, O)
    np.testing.assert_array_equal(sd["decoder.convtsp4.6.weight"].numpy(),
                                  w.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        sd["backbone.base2.0.branch1.1.bn_t.running_var"].numpy(),
        state["backbone"]["base2"]["0"]["branch1"]["1"]["bn_t"]["var"])


def test_load_weights_npz_keeps_bf16_leaves(trees):
    sd = load_weights(FIXTURE)
    ref = from_jax_trees(*trees)
    assert set(sd) == set(ref)
    w = sd["backbone.base1.0.conv_s.weight"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (64, 3, 1, 7, 7)
    for k in ("backbone.base1.0.conv_s.weight", "decoder.convtsp4.8.bias",
              "backbone.base4.1.branch3.1.bn.running_mean"):
        np.testing.assert_array_equal(sd[k].float().numpy(), ref[k].numpy())
    ViNet(3, 32).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("prefix", ["", "module."])
def test_load_weights_reference_pt_loads_strictly(prefix, trees, tmp_path):
    """A reference .pt, as exported, and as saved from nn.DataParallel."""
    params, state = trees
    path = str(tmp_path / "vinet.pt")
    export_torch_checkpoint(path, JaxViNet(3, 32), params, state)
    if prefix:
        sd = torch.load(path, weights_only=True)
        torch.save({prefix + k: v for k, v in sd.items()}, path)
    model = ViNet(3, 32)
    model.load_state_dict(load_weights(path), strict=True)
    np.testing.assert_array_equal(model.decoder.convtsp1[0].weight.detach().numpy(),
                                  params["decoder"]["conv1"]["w"].transpose(4, 3, 0, 1, 2))


def test_s3d_pyramid_matches_jax(port_model, clip, jax_pyramid):
    with torch.no_grad():
        got = port_model.backbone(torch.from_numpy(ndhwc_to_ncdhw(clip)))
    want_shapes = [(1, 4, 1, 1, 1024), (1, 8, 2, 2, 832), (1, 16, 4, 4, 480),
                   (1, 16, 8, 8, 192)]
    for level, (g, w, shape) in enumerate(zip(got, jax_pyramid, want_shapes)):
        g = ncdhw_to_ndhwc(g.numpy())
        assert g.shape == w.shape == shape, level
        print(f"level y{level}: max|err| {_max_err(g, w):.3g}")
        assert _max_err(g, w) < TOL, (level, _max_err(g, w))


@pytest.mark.parametrize("phasefold", ["0", "1"])
def test_decoder_32_matches_jax_tails(phasefold, trees, port_model, jax_pyramid, monkeypatch):
    """The port's tail (the head fused with the last upsample, the kernel's
    path) against the JAX package's default phase-folded tail, which also
    never forms the upsampled z5, and its unfolded tail (VINET_PHASEFOLD=0,
    through the head reference)."""
    monkeypatch.setenv("VINET_PHASEFOLD", phasefold)
    want, _ = JaxDecoder(jax_decoder_plan(3, 32)).apply(
        trees[0]["decoder"], {}, [jnp.asarray(y) for y in jax_pyramid])
    with torch.no_grad():
        got = port_model.decoder([torch.from_numpy(ndhwc_to_ncdhw(y)) for y in jax_pyramid])
    assert tuple(got.shape) == want.shape == (1, 32, 32)
    print(f"max|err| {_max_err(got.numpy(), want):.3g}")
    assert _max_err(got.numpy(), want) < TOL, _max_err(got.numpy(), want)


def test_decoder_32_tail_goes_through_head_wrapper(port_model, jax_pyramid, monkeypatch):
    """The decoder hands the fused head wrapper the coarse z5, contiguous."""
    calls = []
    plain = head.saliency_head_up2x

    def spy(z5, w6, b6, w7, b7):
        calls.append((tuple(z5.shape), z5.is_contiguous(), tuple(w6.shape), b6 is None))
        return plain(z5, w6, b6, w7, b7)

    monkeypatch.setattr(head, "saliency_head_up2x", spy)
    with torch.no_grad():
        out = port_model.decoder([torch.from_numpy(ndhwc_to_ncdhw(y)) for y in jax_pyramid])
    assert calls == [((1, 32, 2, 16, 16), True, (32, 32, 2, 1, 1), True)]
    assert tuple(out.shape) == (1, 32, 32)


def test_decoder_32_fused_tail_equals_upsample_then_head(port_model, jax_pyramid):
    """The fused tail against the full-resolution head on the port's own
    upsample of z5, in f32: exact up to the order of f32 sums."""
    dec = port_model.decoder
    pyr = [torch.from_numpy(ndhwc_to_ncdhw(y)) for y in jax_pyramid]
    with torch.no_grad():
        got = dec(pyr)
        y0, y1, y2, y3 = pyr
        z = torch.cat([dec.convtsp1(y0), y1], dim=2)
        z = torch.cat([dec.convtsp2(z), y2], dim=2)
        z = torch.cat([dec.convtsp3(z), y3], dim=2)
        z = dec.convtsp4[:6](z)  # conv4, relu, up, conv5, relu, up
        conv6, conv7 = dec.convtsp4[6], dec.convtsp4[8]
        want = head.saliency_head(z, conv6.weight, conv6.bias, conv7.weight, conv7.bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_decoder_plans_match_jax():
    from vinet_tpu.models.decoder import DECODER_PLANS as JAX_PLANS

    assert {k: tuple(vars(v).values()) for k, v in DECODER_PLANS.items()} == \
        {k: tuple(vars(v).values()) for k, v in JAX_PLANS.items()}
