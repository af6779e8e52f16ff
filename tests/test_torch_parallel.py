"""vinet_tpu_torch's parallel package against vinet_tpu's: the bring-up, the
mesh's layout, the model axis's partition rules and the collectives.

- ``utils/runtime.py::init_distributed`` in its three modes: the JAX
  package's VINET_* variables and torchrun's (one world of 2 spawned gloo
  ranks joins through the first, leaves, and joins again through the
  second), and neither, which gives (0, 1) without a group, while an
  explicit bring-up that fails raises;
- ``create_mesh``: rank -> (data, model) coordinates and each axis's group
  equal JAX's device layout (``create_mesh(jax.devices()[:n], model=m)``)
  for worlds 2, 4 and 8 and models 1, 2 and 4 (torch.distributed faked for
  the worlds, so that every rank's view is checked in this process), and a
  world that the model axis does not divide raises JAX's message;
- ``param_partition_specs`` leaf for leaf against JAX's, through the weight
  bridge: JAX's specs mark each leaf's sharded axis, ``from_jax_trees``
  carries the marks into torch's layouts, and the port's spec must name that
  dim (or None), on the fixture's ViNet(3, 32) and on AViNet's trees
  (``torch_port_util.av_trees``), with and without the encoder, at model 2
  and 4 (no JAX compile);
- the collectives' forward and backward on the 2 ranks, against the
  analytic result.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import PartitionSpec

from tests.torch_port_util import (FIXTURE, TORCH_THREADS, World, _free_port, av_trees,
                                   collective_cases, collective_input, collective_weight,
                                   fixture_trees, rank_collectives)
from vinet_tpu.parallel import create_mesh as jax_create_mesh
from vinet_tpu.parallel import param_partition_specs as jax_specs
from vinet_tpu_torch.io.weights import from_jax_trees
from vinet_tpu_torch.models import ViNet
from vinet_tpu_torch.parallel import Mesh, all_gather, all_reduce, create_mesh
from vinet_tpu_torch.parallel import param_partition_specs
from vinet_tpu_torch.utils.runtime import init_distributed

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(rank_collectives, 2, _free_port(),
                 workdir=tmp_path_factory.mktemp("world")).results()


@pytest.mark.parametrize("launcher", ["vinet", "torchrun"])
def test_init_distributed_joins_the_world(world, launcher):
    assert [r[launcher] for r in world] == [(0, 2, "gloo"), (1, 2, "gloo")]


def test_init_distributed_without_a_launcher_is_one_process(monkeypatch):
    for k in ("VINET_COORDINATOR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed("cpu") == (0, 1)
    assert not dist.is_initialized()
    monkeypatch.setenv("VINET_COORDINATOR", "localhost:1")  # VINET_NUM_PROCESSES missing
    monkeypatch.delenv("VINET_NUM_PROCESSES", raising=False)
    with pytest.raises(KeyError, match="VINET_NUM_PROCESSES"):
        init_distributed("cpu")
    assert not dist.is_initialized()


class _FakeWorld:
    """torch.distributed as rank `rank` of a world of n sees it; new_group
    returns the group's ranks."""

    def __init__(self, monkeypatch, rank: int, n: int):
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: n)
        monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
        monkeypatch.setattr(dist, "new_group", lambda ranks, **kw: tuple(ranks))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("model", [1, 2, 4])
def test_create_mesh_layout_equals_jax(monkeypatch, n, model):
    devices = jax.devices()[:n]
    if n % model:
        with pytest.raises(ValueError) as jax_err:
            jax_create_mesh(devices, model=model)
        _FakeWorld(monkeypatch, 0, n)
        with pytest.raises(ValueError) as port_err:
            create_mesh(model=model)
        assert str(port_err.value) == str(jax_err.value)
        return
    # rank r <-> device r: JAX's mesh array of device positions
    pos = np.vectorize(lambda d: devices.index(d))(jax_create_mesh(devices, model=model).devices)
    assert pos.shape == (n // model, model)
    for rank in range(n):
        _FakeWorld(monkeypatch, rank, n)
        mesh = create_mesh(model=model)
        (i, j), = np.argwhere(pos == rank)
        assert mesh.coords == (i, j) and mesh.shape == {"data": n // model, "model": model}
        data, along = tuple(pos[:, j].tolist()), tuple(pos[i, :].tolist())
        assert mesh.groups["data"] == (data if len(data) > 1 else None)
        assert mesh.groups["model"] == (along if len(along) > 1 else None)


def _bridged_dims(params: dict, state: dict, model: int) -> dict:
    """JAX's specs carried into torch's layouts: every leaf filled with its
    index along its sharded axis (0 where replicated), through
    from_jax_trees; {name: the dim along which the tensor varies, or None}."""
    mesh = jax_create_mesh(jax.devices()[:model], model=model)

    def marks(tree):
        specs = jax_specs(tree, mesh)

        def mark(leaf, spec):
            leaf = np.asarray(leaf)
            axes = [a for a, name in enumerate(spec) if name == "model"]
            if not axes:
                return np.zeros(leaf.shape, np.float32)
            shape = [1] * leaf.ndim
            shape[axes[0]] = leaf.shape[axes[0]]
            return np.broadcast_to(np.arange(leaf.shape[axes[0]], dtype=np.float32)
                                   .reshape(shape), leaf.shape).copy()

        return jax.tree_util.tree_map(mark, tree, specs,
                                      is_leaf=lambda x: isinstance(x, PartitionSpec))

    out = {}
    for name, t in from_jax_trees(marks(params), marks(state)).items():
        if name.endswith("pos_encoder.pe"):  # the bridge's sin/cos table is no JAX leaf
            continue
        dims = [d for d in range(t.dim()) if t.shape[d] > 1
                and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        assert len(dims) <= 1, (name, dims)
        out[name] = dims[0] if dims else None
    return out


@pytest.fixture(scope="module")
def models():
    from vinet_tpu_torch.inference.accuracy import av_fixture_model

    vinet = ViNet(3, 32)
    out = {"vinet": (vinet, fixture_trees())}
    for enc in (False, True):
        _, params, state = av_trees(use_transformer=enc)
        port = av_fixture_model(FIXTURE, seed=0, use_transformer=enc, input_hw=(64, 96))
        out[f"avinet_encoder_{enc}"] = (port, (params, state))
    return out


@pytest.mark.parametrize("name", ["vinet", "avinet_encoder_False", "avinet_encoder_True"])
@pytest.mark.parametrize("model", [2, 4])
def test_partition_specs_equal_jax_through_the_bridge(models, name, model):
    port, trees = models[name]
    want = _bridged_dims(*trees, model)
    got = param_partition_specs(port, Mesh({"data": 1, "model": model}, (0, 0), {}))
    assert set(want) <= set(got)
    for k, dim in got.items():
        assert dim == want.get(k), (k, dim, want.get(k))
    assert sum(d is not None for d in got.values()) > 100


def test_collectives_are_the_identity_without_a_group():
    x = torch.ones(3)
    assert all_reduce(x, None) is x and all_gather(x, None) is x
    with pytest.raises(ValueError):
        all_reduce(x, None, "max")


@pytest.mark.parametrize("case", list(collective_cases()))
def test_collective_forward_and_backward_on_two_ranks(world, case):
    xs = [collective_input(r).numpy() for r in range(2)]
    if case.startswith("all_reduce"):
        y = sum(xs) / (2 if case.endswith("mean") else 1)
        ws = [collective_weight(r, y.shape, case).numpy() for r in range(2)]
        dx = [sum(ws) / (2 if case.endswith("mean") else 1)] * 2
    else:
        y = np.concatenate(xs, axis=1)
        ws = [collective_weight(r, y.shape, case).numpy() for r in range(2)]
        full = ws[0] if case.endswith("slice") else sum(ws)
        dx = [full[:, :3], full[:, 3:]]
    for r in range(2):
        got_y, got_dx = world[r][case]
        np.testing.assert_allclose(got_y, y, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got_dx, dx[r], rtol=0, atol=1e-12)
