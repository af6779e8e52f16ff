"""vinet_tpu_torch's TASEDv2 against vinet_tpu's, on the CPU.

- ``conv_transpose3d`` (``vinet_tpu/ops/conv.py``) against torch's
  ``F.conv_transpose3d`` on the weight the bridge (``from_jax_trees``) makes
  of the JAX one, with I != O and with I = O, where a wrong permutation
  would load without a shape error; rtol/atol 1e-4 (``tests/
  test_completeness.py``'s);
- the shapes at 32 x 224 x 384: y0 and every decoder stage by
  ``jax.eval_shape`` against the port's module on the meta device;
- the eval forward at 32 x 64 x 96, f32, against ``TASEDv2.apply`` jitted
  with the trees as arguments (the first JAX compile). The trees are
  ``bn_tree`` over ``jax.eval_shape`` (never ``TASEDv2.init``), with the
  running statistics then taken from one seeded batch in the port (momentum
  1), so that every stage sees unit-scale activations and the maps spread
  over (0, 1); JAX gets them through ``to_jax_trees``. Max error < 2e-3
  (the port's anchor; 2.1e-4 measured);
- one train-mode forward of batch 2 (the second JAX compile: the train
  step's forward, ``tests/torch_port_util.py::jax_train_forward``), JAX's
  and the port's f32 each against the port in float64 as the arbiter, as
  for AViNet: the loss within 1e-5 relative and every new BatchNorm
  statistic within 1e-5 of its tensor's largest value (the AV train step's
  bounds), the maps within 2e-4 for the port and 5e-3 for JAX, whose
  one-pass f32 variance over the few positions of the deep layers (y0 is 4
  x 2 x 3 at 64 x 96) drifts further (1.9e-3 measured; the port's f32
  1.2e-4);
- ``param_partition_specs`` at model 2 against JAX's through the bridge,
  the six ConvTranspose3d weights on dim 1 (JAX's O axis);
- a reference-named state_dict (a twin of the reference's TASED_v2 built
  here on ``tests/torch_ref.py``'s S3D) saved as a ``.pt`` loads with
  ``strict=True`` through ``load_weights`` and gives the twin's maps.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax
import jax.numpy as jnp

from tests.test_torch_parallel import _bridged_dims
from tests.torch_port_util import (TORCH_THREADS, bn_tree, jax_train_forward,
                                   ncdhw_to_ndhwc, normalized_clip)
from tests.torch_ref import TBackbone
from vinet_tpu.models.s3d import S3DBackbone as JaxS3D
from vinet_tpu.models.tased import TASEDv2 as JaxTASED
from vinet_tpu.ops.conv import conv_transpose3d
from vinet_tpu_torch.io.weights import (TASED_TRANSPOSED, from_jax_trees, load_weights,
                                        to_jax_trees)
from vinet_tpu_torch.models import TASEDv2
from vinet_tpu_torch.ops.norm import override_momentum
from vinet_tpu_torch.parallel import Mesh, param_partition_specs
from vinet_tpu_torch.training.losses import LossConfig, loss_func

torch.set_num_threads(TORCH_THREADS)
HW = (64, 96)


@pytest.fixture(scope="module")
def trees():
    shapes = jax.eval_shape(JaxTASED().init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return bn_tree(shapes[0], rng), bn_tree(shapes[1], rng)


def _port(params, state, dtype=torch.float32) -> TASEDv2:
    model = TASEDv2()
    model.load_state_dict(from_jax_trees(params, state), strict=True)
    return model.to(dtype)


@pytest.mark.parametrize("where, i, o", [("convtsp4.0", 6, 5), ("convtsp4.12", 4, 4)])
def test_conv_transpose3d_matches_torch_through_the_bridge(where, i, o):
    rng = np.random.default_rng(i)
    x = rng.standard_normal((2, 3, 5, 6, i)).astype(np.float32)
    w = rng.standard_normal((1, 4, 4, i, o)).astype(np.float32)  # kT, kH, kW, I, O
    stage, idx = where.split(".")
    wt = from_jax_trees({stage: {idx: {"w": w}}}, {})[f"{where}.weight"]
    assert where in TASED_TRANSPOSED and tuple(wt.shape) == (i, o, 1, 4, 4)
    want = np.asarray(conv_transpose3d(jnp.asarray(x), jnp.asarray(w), stride=(1, 2, 2),
                                       padding=(0, 1, 1)))
    got = F.conv_transpose3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), wt, stride=(1, 2, 2),
                             padding=(0, 1, 1))
    got = ncdhw_to_ndhwc(got.numpy())
    assert got.shape == want.shape == (2, 3, 10, 12, o)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_shapes_at_224x384_match_jax(trees):
    jm = JaxTASED()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((1, 32, 224, 384, 3), jnp.float32)
    bb = {k: shapes[0][k] for k in ("base1", "base2", "base3", "base4")}
    bbs = {k: shapes[1][k] for k in bb if k in shapes[1]}
    z = jax.eval_shape(lambda p, s, x: JaxS3D().apply(p, s, x)[0][0], bb, bbs, x)
    want = {"base4": z.shape}
    for name, mod in jm._decoder().items():
        z = jax.eval_shape(lambda p, s, z: mod.apply(p, s, z)[0], shapes[0][name],
                           shapes[1].get(name, {}), z)
        want[name] = z.shape
    final = jax.eval_shape(lambda p, s, x: jm.apply(p, s, x)[0], *shapes, x).shape

    got = {}
    with torch.device("meta"):
        model = TASEDv2().eval()
        for name in want:
            getattr(model, name).register_forward_hook(
                lambda m, i, o, name=name: got.__setitem__(name, tuple(o.shape)))
        out = model(torch.empty(1, 32, 224, 384, 3))
    # NCDHW -> NDHWC
    assert {k: (v[0], *v[2:], v[1]) for k, v in got.items()} == want
    assert tuple(out.shape) == final == (1, 224, 384)
    assert want["base4"] == (1, 4, 7, 12, 1024) and want["convtsp4"] == (1, 1, 224, 384, 1)


@pytest.fixture(scope="module")
def calibrated(trees):
    """The port's model on the trees, its running statistics those of one
    seeded batch, and the JAX trees of it."""
    model = _port(*trees).train()
    with torch.no_grad(), override_momentum(model, 1.0):
        model(torch.from_numpy(normalized_clip(2, (2, 32, *HW, 3))))
    model.eval()
    return model, to_jax_trees(model.state_dict())


def test_eval_forward_matches_jax(calibrated):
    model, (params, state) = calibrated
    x = normalized_clip(1, (2, 32, *HW, 3))
    want = np.asarray(jax.jit(lambda p, s, x: JaxTASED().apply(p, s, x)[0])(params, state, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    err = float(np.abs(got - want).max())
    print(f"TASEDv2 eval f32 max|err| {err:.3g}, map std {want.std():.3g}")
    assert got.shape == want.shape == (2, *HW)
    assert ((got >= 0) & (got <= 1)).all() and want.std() > 0.05
    assert err < 2e-3


def test_train_forward_maps_and_statistics_match_jax(trees):
    params, state = trees
    rng = np.random.default_rng(5)
    batch = {"clip": normalized_clip(3, (2, 32, *HW, 3)),
             "gt": np.clip(rng.random((2, *HW)), 0.05, 1.0).astype(np.float32)}
    jax_map, jax_loss, jax_state = jax_train_forward(JaxTASED())(params, state, batch)
    runs = {"jax": (jax_map, float(jax_loss), from_jax_trees(params, jax_state))}
    for name, dtype in (("port f32", torch.float32), ("port f64", torch.float64)):
        model = _port(params, state, dtype).train()
        with torch.no_grad():
            m = model(torch.from_numpy(batch["clip"]).to(dtype))
        loss = float(loss_func(m, torch.from_numpy(batch["gt"]).to(dtype), LossConfig()))
        runs[name] = (m.double().numpy(), loss, model.state_dict())
    arbiter_map, arbiter_loss, arbiter_sd = runs.pop("port f64")
    stats = [k for k in arbiter_sd if "running" in k]
    assert len(stats) > 100 and arbiter_map.std() > 0.05
    errs = {}
    for name, (got_map, loss, sd) in runs.items():
        errs[name] = (float(np.abs(np.asarray(got_map, np.float64) - arbiter_map).max()),
                      abs(loss - arbiter_loss) / abs(arbiter_loss),
                      max(float((sd[k].double() - arbiter_sd[k]).abs().max()
                                / arbiter_sd[k].abs().max()) for k in stats))
        print(f"{name} vs float64: map {errs[name][0]:.3g}, loss {errs[name][1]:.3g} rel, "
              f"statistics {errs[name][2]:.3g}")
    assert all(loss <= 1e-5 and stat <= 1e-5 for _, loss, stat in errs.values()), errs
    assert errs["port f32"][0] <= 2e-4 and errs["jax"][0] <= 5e-3, errs


def test_partition_specs_equal_jax_at_model_2(trees):
    want = _bridged_dims(*trees, 2)
    got = param_partition_specs(TASEDv2(), Mesh({"data": 1, "model": 2}, (0, 0), {}))
    assert set(want) <= set(got)
    for k, dim in got.items():
        assert dim == want.get(k), (k, dim, want.get(k))
    assert {k for k, d in got.items() if d == 1} == {f"{n}.weight" for n in TASED_TRANSPOSED}


class _TwinTASED(TBackbone):
    """The reference's TASED_v2 (its model_utils.py:5-126) by name and
    semantics: the S3D twin's stages at the top level, convtsp1-4 as
    Sequentials of ConvTranspose3d / Conv3d / BatchNorm3d(eps 1e-3,
    momentum 0.001) / ReLU, the maps the last stage's (B, 1, 1, H, W)."""

    def __init__(self):
        super().__init__()

        def bn(c):
            return nn.BatchNorm3d(c, eps=1e-3, momentum=0.001)

        def ct(i, o, k=(1, 4, 4), s=(1, 2, 2), p=(0, 1, 1)):
            return nn.ConvTranspose3d(i, o, k, s, p, bias=False)

        self.convtsp1 = nn.Sequential(nn.Conv3d(1024, 1024, 1, bias=False), bn(1024), nn.ReLU(),
                                      ct(1024, 832), bn(832), nn.ReLU())
        self.convtsp2 = nn.Sequential(ct(832, 480), bn(480), nn.ReLU())
        self.convtsp3 = nn.Sequential(ct(480, 192), bn(192), nn.ReLU())
        self.convtsp4 = nn.Sequential(
            ct(192, 64), bn(64), nn.ReLU(),
            nn.Conv3d(64, 64, (2, 1, 1), (2, 1, 1), bias=False), bn(64), nn.ReLU(),
            ct(64, 4, 1, 1, 0), bn(4), nn.ReLU(),
            nn.Conv3d(4, 4, (2, 1, 1), (2, 1, 1), bias=False), bn(4), nn.ReLU(),
            ct(4, 4), nn.Conv3d(4, 1, 1, bias=True), nn.Sigmoid())

    def forward(self, x):
        z = super().forward(x)[0]
        z = self.convtsp4(self.convtsp3(self.convtsp2(self.convtsp1(z))))
        return z.view(z.size(0), z.size(3), z.size(4))


def test_reference_state_dict_loads_strictly(tmp_path, calibrated):
    twin = _TwinTASED().eval()
    twin.load_state_dict(calibrated[0].state_dict(), strict=True)
    path = str(tmp_path / "TASED_v2.pt")
    torch.save(twin.state_dict(), path)
    port = TASEDv2().eval()
    port.load_state_dict(load_weights(path), strict=True)
    os.remove(path)  # 31 M values
    x = normalized_clip(4, (1, 32, *HW, 3))
    with torch.no_grad():
        want = twin(torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()).numpy()
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
