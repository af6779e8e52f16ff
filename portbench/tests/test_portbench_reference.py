"""The plain reference against the program at a tiny size on the CPU, in
f32: the same weights give the same maps (the program folds BatchNorm and
ends in its head kernel's plain version), and the reference's resize, blur
and quantisation give the program's uint8 maps."""

import torch

from portbench.reference.models import RefAViNet, RefViNet
from portbench.reference.post import post
from portbench.reference.weights import fixture_state_dict, seeded_leaves

FIXTURE = "artifacts/streamft_fixture.npz"


def _clip(seed, b=2, h=32, w=64):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, 32, h, w, 3), generator=g, dtype=torch.uint8)


def test_vinet_matches_the_program():
    from vinet_tpu_torch.data.pipeline import device_preprocess
    from vinet_tpu_torch.inference.engine import prepared_copy
    from vinet_tpu_torch.models import ViNet

    sd = fixture_state_dict(FIXTURE)
    ref = RefViNet().eval()
    ref.load_state_dict(sd, strict=True)
    prog = ViNet(3, 32)
    prog.load_state_dict(sd, strict=True)
    prog = prepared_copy(prog, torch.float32, "cpu")
    x = device_preprocess(_clip(1))
    with torch.no_grad():
        want = ref(x.permute(0, 4, 1, 2, 3))
        got = prog(x).float()
    assert (got - want).abs().max() < 2e-4


def test_avinet_matches_the_program():
    from vinet_tpu_torch.data.pipeline import device_preprocess
    from vinet_tpu_torch.inference.engine import prepared_copy
    from vinet_tpu_torch.models import AViNet

    prog = AViNet(input_hw=(32, 64))
    sd = {f"visual_model.{k}": v for k, v in fixture_state_dict(FIXTURE).items()}
    sd.update(seeded_leaves({k: v.shape for k, v in prog.state_dict().items() if k not in sd},
                            3, "cpu"))
    prog.load_state_dict(sd, strict=True)
    ref = RefAViNet((4, 1, 2)).eval()
    ref.load_state_dict(sd, strict=True)
    prog = prepared_copy(prog, torch.float32, "cpu")
    x = device_preprocess(_clip(2))
    audio = 1e-3 * torch.randn(2, 70560, 1, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = ref(x.permute(0, 4, 1, 2, 3), audio[..., 0])
        got = prog(x, audio).float()
    assert (got - want).abs().max() < 2e-4


def test_post_matches_the_program():
    from vinet_tpu_torch.ops.image import gaussian_blur, quantize_maps_u8, resize_bilinear

    maps = torch.rand(3, 28, 48, generator=torch.Generator().manual_seed(5))
    want = quantize_maps_u8(gaussian_blur(resize_bilinear(maps, 45, 80), ksize=11))
    got = post(maps, (45, 80))
    assert (got.int() - want.int()).abs().max() <= 1
    assert (got != want).float().mean() < 1e-3
