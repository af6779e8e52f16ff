"""``models/s3d.py::run_in_time`` on the CPU: each S3D layer the streaming
(dense) and live (valid) paths run, in each time form, against the explicit
``F.conv3d``/``F.max_pool3d`` expression of that form, bit for bit in f32,
with its time radius; and what has no time form refused."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from vinet_tpu_torch.models.s3d import S3DBackbone, run_in_time

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def backbone():
    """A seeded S3D in eval mode whose BatchNorms have non-trivial running
    statistics and affine parameters."""
    torch.manual_seed(0)
    bb = S3DBackbone().eval()
    with torch.no_grad():
        for m in bb.modules():
            if isinstance(m, nn.BatchNorm3d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
    return bb


def _basic(m, x):
    """A BasicConv3d: its 1 x 1 x 1 conv has no time extent."""
    return torch.relu(m.bn(F.conv3d(x, m.conv.weight, m.conv.bias)))


def _sep(m, x, pt):
    """A SepConv3d with time stride 1 and time padding pt."""
    cs, ct = m.conv_s, m.conv_t
    s = torch.relu(m.bn_s(F.conv3d(x, cs.weight, cs.bias, stride=(1, *cs.stride[1:]),
                                   padding=(0, *cs.padding[1:]))))
    return torch.relu(m.bn_t(F.conv3d(s, ct.weight, ct.bias, stride=(1, 1, 1),
                                      padding=(pt, 0, 0))))


def _mixed(m, x, pt):
    """An InceptionBlock, branch 0 (radius 0) trimmed to the others' radius 1
    where the time padding pt is dropped."""
    cut = 1 - pt
    b0 = _basic(m.branch0[0], x)
    return torch.cat([b0[:, :, cut: b0.shape[2] - cut],
                      _sep(m.branch1[1], _basic(m.branch1[0], x), pt),
                      _sep(m.branch2[1], _basic(m.branch2[0], x), pt),
                      _basic(m.branch3[1], F.max_pool3d(x, 3, 1, (pt, 1, 1)))], dim=1)


# (layer, module, input shape, want(module, x, pt), radius): pt is 1 where a
# form keeps the module's own time padding ("dense") and 0 where it drops it
# ("valid"); the stem's own padding is 3
LAYERS = [
    ("stem", lambda b: b.base1[0], (2, 3, 9, 20, 20), lambda m, x, pt: _sep(m, x, 3 * pt), 3),
    ("sep_3b", lambda b: b.base2[0].branch1[1], (1, 96, 6, 5, 5), _sep, 1),
    ("mixed_3b", lambda b: b.base2[0], (1, 192, 6, 5, 5), _mixed, 1),
    ("basic", lambda b: b.base1[2], (1, 64, 5, 6, 6), lambda m, x, pt: _basic(m, x), 0),
    ("maxp2", lambda b: b.maxp2, (1, 8, 5, 9, 11),
     lambda m, x, pt: F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1)), 0),
    ("maxp3", lambda b: b.maxp3, (1, 8, 7, 9, 11),
     lambda m, x, pt: F.max_pool3d(x, 3, (1, 2, 2), (pt, 1, 1)), 1),
    ("maxt4", lambda b: b.maxt4, (1, 8, 5, 5, 7),
     lambda m, x, pt: F.max_pool3d(x, (2, 1, 1), 1, 0), 0),
    ("maxp4", lambda b: b.maxp4, (1, 8, 3, 5, 7),
     lambda m, x, pt: F.max_pool3d(x, (1, 2, 2), (1, 2, 2), 0), 0),
    ("branch3_pool", lambda b: b.base3[0].branch3[0], (1, 8, 6, 5, 7),
     lambda m, x, pt: F.max_pool3d(x, 3, 1, (pt, 1, 1)), 1),
]


@pytest.mark.parametrize("form", ["dense", "valid"])
@pytest.mark.parametrize("name,pick,shape,want,radius", LAYERS, ids=[c[0] for c in LAYERS])
def test_each_layer_in_each_time_form_is_its_explicit_expression(
        backbone, name, pick, shape, want, radius, form):
    mod = pick(backbone)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, r = run_in_time(mod, x, form)
        expected = want(mod, x, 1 if form == "dense" else 0)
    assert r == radius
    assert got.dtype == torch.float32 and got.shape == expected.shape
    assert torch.equal(got, expected)
    # the valid form loses the radius at each end (maxt4's window 2 its one
    # future step), the dense form maxt4's step alone
    lost = 2 * radius if form == "valid" else 0
    assert got.shape[2] == shape[2] - lost - (name == "maxt4")


@pytest.mark.parametrize("mod,form", [
    (nn.MaxPool3d(3, 1, 0), "valid"),  # an odd time window without padding: no radius
    (nn.Conv3d(4, 4, (3, 1, 1), padding=(1, 0, 0)), "dense"),  # a bare conv with a time extent
    (nn.ReLU(), "valid"),
    (nn.Identity(), "parity"),
], ids=["pool", "conv", "module", "form"])
def test_what_has_no_time_form_is_refused(mod, form):
    with pytest.raises((ValueError, TypeError)):
        run_in_time(mod, torch.zeros((1, 4, 5, 3, 3)), form)
