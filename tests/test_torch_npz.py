"""The port's ``.npz`` writer (``io/weights.py::to_jax_trees`` and
``save_npz_trees``) against vinet_tpu's ``save_npz_tree`` and
``load_npz_tree``, on the CPU, with no JAX compile.

For ViNet(3, 32) (the fixture's trees: conv6), ViNet(3, 8) (no conv6),
AViNet with and without its refinement encoder (``av_trees``),
AViNetFusion (clip 8, 64 x 96) and TASEDv2 (``bn_tree`` over
``jax.eval_shape``), each from JAX trees T through ``from_jax_trees`` into
the port's model:

- ``to_jax_trees`` of the model's state_dict is T, key for key in the order
  JAX's pytrees keep (sorted: the JAX CLI saves host copies of jitted
  states), dtype, shape and bits equal; the sin/cos tables and
  ``num_batches_tracked`` are gone;
- the file ``save_npz_trees`` writes has the members of JAX's
  ``save_npz_tree`` of T, in the same order, each member's bytes equal
  (header and data; only the zip's timestamps differ), in f32 and with every
  leaf in bf16 (the 2-byte void JAX's reader takes);
- JAX's ``load_npz_tree`` (template from ``eval_shape``) reads it back to T,
  and the port's ``load_model_weights`` strictly into the model with every
  tensor zeroed, which then holds its state_dict again.

int8 ``QuantConv3d`` buffers raise.
"""

import copy
import os
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

from tests.torch_port_util import (TORCH_THREADS, av_bn_trees, av_trees, bn_tree,
                                   fixture_trees)
from vinet_tpu.io.convert import load_npz_tree, save_npz_tree
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu.models.tased import TASEDv2 as JaxTASED
from vinet_tpu_torch.io.weights import (from_jax_trees, load_model_weights, save_npz_trees,
                                        to_jax_trees)
from vinet_tpu_torch.models import AViNet, AViNetFusion, TASEDv2, ViNet

torch.set_num_threads(TORCH_THREADS)
CASES = ["vinet_conv6", "vinet_no_conv6", "avinet", "avinet_encoder", "fusion", "tased"]


def _case(name: str):
    """(JAX template trees (eval_shape), JAX trees T, a fresh port model)."""
    if name.startswith("avinet"):
        enc = name.endswith("encoder")
        jm, params, state = av_trees(use_transformer=enc)
        return (jax.eval_shape(jm.init, jax.random.PRNGKey(0)), (params, state),
                lambda: AViNet(use_transformer=enc, input_hw=(64, 96)))
    if name == "fusion":
        jm, params, state = av_bn_trees(fusion=True, input_hw=(64, 96), clip_size=8)
        return (jax.eval_shape(jm.init, jax.random.PRNGKey(0)), (params, state),
                lambda: AViNetFusion(clip_size=8, input_hw=(64, 96)))
    jm, make, clip = {"vinet_conv6": (JaxViNet(3, 32), ViNet, 32),
                      "vinet_no_conv6": (JaxViNet(3, 8), ViNet, 8),
                      "tased": (JaxTASED(), TASEDv2, None)}[name]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    if name == "vinet_conv6":
        trees = fixture_trees()
    else:
        rng = np.random.default_rng(0)
        trees = (bn_tree(shapes[0], rng), bn_tree(shapes[1], rng))
    return shapes, trees, (lambda: make(3, clip)) if clip else make


def _sorted(tree):
    """T as the JAX CLI saves it, a host copy of a jitted state: keys sorted
    at every level, C-ordered numpy leaves (the fixture's file holds some
    Fortran-ordered ones, which no jax.Array gives)."""
    return jax.tree_util.tree_map(np.ascontiguousarray, tree)


def _assert_same_trees(got: dict, want: dict, path: str = "") -> None:
    assert list(got) == list(want), (path, list(got)[:6], list(want)[:6])
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_same_trees(got[k], w, f"{path}.{k}")
            continue
        g, w = np.asarray(got[k]), np.asarray(w)
        assert (g.dtype.str, g.shape) == (w.dtype.str, w.shape), (path, k, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), (path, k)


def _members(path) -> list:
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    shapes, trees, make = _case(request.param)
    model = make()
    pe = getattr(getattr(model, "transformer", None), "pos_encoder", None)
    kw = {} if pe is None else {"pe_len": pe.pe.shape[0]}
    model.load_state_dict(from_jax_trees(*trees, **kw), strict=True)
    return request.param, shapes, _sorted(trees), model, make


def test_to_jax_trees_inverts_the_bridge(case):
    _, _, trees, model, _ = case
    params, state = to_jax_trees(model.state_dict())
    _assert_same_trees(params, trees[0])
    _assert_same_trees(state, trees[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_npz_trees_writes_jax_members(case, dtype, tmp_path):
    name, shapes, trees, model, _ = case
    if dtype == "bfloat16":
        trees = jax.tree_util.tree_map(lambda a: a.astype(ml_dtypes.bfloat16), trees)
        model = copy.deepcopy(model).to(torch.bfloat16)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_npz_trees(ours, *to_jax_trees(model.state_dict()))
    save_npz_tree(theirs, *trees)
    got, want = _members(ours), _members(theirs)
    os.remove(theirs)  # a full-width model's file is 100-200 MB
    assert [n for n, _ in got] == [n for n, _ in want] and len(want) > 100
    assert [n for n, b in got if b != dict(want)[n]] == []
    del got, want

    # both readers take it
    for got_tree, want_tree in zip(load_npz_tree(ours, *shapes), trees):
        _assert_same_trees(jax.tree_util.tree_map(np.asarray, got_tree), want_tree)
    want_sd = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for v in model.state_dict().values():
            v.zero_()
    load_model_weights(model, ours)
    os.remove(ours)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert v.dtype == want_sd[k].dtype and torch.equal(v, want_sd[k]), k


def test_int8_buffers_raise():
    with pytest.raises(ValueError, match="int8 QuantConv3d"):
        to_jax_trees({"backbone.base1.0.conv_s.w_q": torch.zeros(1, dtype=torch.int8)})


def test_a_path_without_the_suffix_gets_it(tmp_path):
    save_npz_trees(str(tmp_path / "best"), {"a": {"w": np.ones(2, np.float32)}}, {})
    assert [n for n, _ in _members(tmp_path / "best.npz")] == ["params/a.w.npy"]
