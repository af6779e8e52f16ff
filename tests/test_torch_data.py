"""vinet_tpu_torch's training data against vinet_tpu's, on the synthetic
directories of ``tests/fixtures.py``: dataset items equal bit for bit for the
same generator, the Loader's batches and order equal, load_map within 1e-6
of JAX's (which resizes with OpenCV), and the S3D Kinetics-400 name surgery
equal to JAX's on a state_dict of ``tests/torch_ref.py``."""

import json
import os

import numpy as np
import pytest
import torch

from tests.fixtures import make_dhf1k
from tests.torch_port_util import TORCH_THREADS
from vinet_tpu.data import datasets as jd
from vinet_tpu.data import pipeline as jp
from vinet_tpu.io.convert import s3d_kinetics_remap as jax_remap
from vinet_tpu.io.images import load_map as jax_load_map
from vinet_tpu_torch.data import datasets as td
from vinet_tpu_torch.data import pipeline as tp
from vinet_tpu_torch.io.images import load_map
from vinet_tpu_torch.io.weights import load_model_weights, load_weights, s3d_kinetics_remap

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def dhf1k_root(tmp_path_factory):
    return str(make_dhf1k(tmp_path_factory.mktemp("dhf1k") / "d", n_videos=3, n_frames=40))


@pytest.fixture(scope="module")
def hollywood_root(tmp_path_factory):
    """A long and a short (5-frame) video: the short one is padded."""
    root = tmp_path_factory.mktemp("holly")
    make_dhf1k(root / "long", n_videos=1, n_frames=20, seed=1)
    make_dhf1k(root / "short", n_videos=1, n_frames=5, seed=2)
    (root / "holly").mkdir()
    os.rename(root / "long" / "001", root / "holly" / "a")
    os.rename(root / "short" / "001", root / "holly" / "b")
    return str(root / "holly")


def _assert_items_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


def _same_items(port_ds, jax_ds, seed=0):
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        _assert_items_equal(port_ds.get(i, np.random.default_rng((seed, i))),
                            jax_ds.get(i, np.random.default_rng((seed, i))))


@pytest.mark.parametrize("mode, kw", [("train", {}), ("val", {}), ("save", {}),
                                      ("train", {"multi_frame": 1}), ("train", {"alternate": 2})])
def test_dhf1k_items_equal_jax(dhf1k_root, mode, kw):
    _same_items(td.DHF1KDataset(dhf1k_root, 8, mode=mode, **kw),
                jd.DHF1KDataset(dhf1k_root, 8, mode=mode, **kw))


@pytest.mark.parametrize("mode", ["train", "val"])
def test_chunk_dataset_items_equal_jax(dhf1k_root, mode):
    _same_items(td.ChunkDataset(dhf1k_root, 16, mode=mode),
                jd.ChunkDataset(dhf1k_root, 16, mode=mode))


@pytest.mark.parametrize("mode, kw", [("train", {}), ("val", {}), ("train", {"multi_frame": 1})])
def test_hollywood_ucf_items_equal_jax(hollywood_root, mode, kw):
    _same_items(td.HollywoodUCFDataset(hollywood_root, 8, mode=mode, **kw),
                jd.HollywoodUCFDataset(hollywood_root, 8, mode=mode, **kw))


def test_chunk_dataset_without_long_videos_raises(dhf1k_root):
    with pytest.raises(ValueError, match="no videos"):
        td.ChunkDataset(dhf1k_root, 64)


@pytest.mark.parametrize("shuffle, drop_last, shard", [(True, True, (0, 1)),
                                                       (True, False, (1, 2)),
                                                       (False, False, (0, 1))])
def test_loader_batches_and_order_equal_jax(dhf1k_root, shuffle, drop_last, shard):
    """Two epochs: the same batches in the same order, window starts drawn
    from the same per-item generators."""
    kw = dict(batch_size=2, shuffle=shuffle, num_workers=2, seed=3, drop_last=drop_last,
              shard=shard)
    port = tp.Loader(td.DHF1KDataset(dhf1k_root, 8, mode="save"), **kw)
    ref = jp.Loader(jd.DHF1KDataset(dhf1k_root, 8, mode="save"), **kw)
    assert len(port) == len(ref)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_items_equal(g, w)
    train_port = tp.Loader(td.DHF1KDataset(dhf1k_root, 8), **kw)
    train_ref = jp.Loader(jd.DHF1KDataset(dhf1k_root, 8), **kw)
    for g, w in zip(list(train_port), list(train_ref)):
        _assert_items_equal(g, w)


def test_loader_stops_its_producer_when_the_consumer_stops(dhf1k_root):
    import threading

    loader = tp.Loader(td.DHF1KDataset(dhf1k_root, 8, mode="save"), batch_size=1,
                       num_workers=1, prefetch=1)
    before = set(threading.enumerate())
    it = iter(loader)
    next(it)
    assert set(threading.enumerate()) - before  # the producer and its pool run
    it.close()
    assert not set(threading.enumerate()) - before


def test_loader_raises_what_an_item_raises(dhf1k_root):
    class Broken:
        def __len__(self):
            return 2

        def get(self, idx, rng):
            raise OSError("unreadable frame")

    with pytest.raises(OSError, match="unreadable"):
        list(tp.Loader(Broken(), batch_size=1, num_workers=1))


@pytest.mark.parametrize("size", [None, (224, 384), (50, 70), (7, 200)])
def test_load_map_matches_jax(dhf1k_root, size):
    for f in ("0001.png", "0017.png"):
        path = os.path.join(dhf1k_root, "002", "maps", f)
        got, want = load_map(path, size=size), jax_load_map(path, size=size)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6


def test_read_fold_list_and_fps_json_equal_jax(tmp_path):
    fold = tmp_path / "list.txt"
    fold.write_text("vid01 120 29.97\n\nvid02 80\nvid03\n")
    fps = tmp_path / "fps.json"
    fps.write_text(json.dumps({"a": 25, "b": 29.97}))
    assert td.read_fold_list(str(fold)) == jd.read_fold_list(str(fold))
    assert td.read_fps_json(str(fps)) == jd.read_fps_json(str(fps))


@pytest.fixture(scope="module")
def kinetics(tmp_path_factory):
    """A reference backbone's state_dict in the flat 'base.N.*' names of
    S3D_kinetics400.pt, with a classifier entry that is not the backbone's."""
    from tests.torch_ref import TBackbone, kinetics_style_state_dict

    torch.manual_seed(0)
    backbone = TBackbone()
    flat = kinetics_style_state_dict(backbone)
    flat["fc.0.weight"] = torch.zeros(400, 1024, 1, 1, 1)
    path = tmp_path_factory.mktemp("kinetics") / "S3D_kinetics400.pt"
    torch.save({"module." + k: v for k, v in flat.items()}, str(path))
    return backbone, flat, str(path)


def test_s3d_kinetics_remap_equals_jax(kinetics):
    _, flat, _ = kinetics
    got, want = s3d_kinetics_remap(flat), jax_remap(flat)
    assert list(got) == list(want)
    assert all(got[k] is want[k] for k in want)


def test_kinetics_file_loads_into_the_backbone_alone(kinetics):
    from vinet_tpu_torch.models import ViNet

    backbone, _, path = kinetics
    sd = load_weights(path)
    assert all(k.startswith("backbone.base") for k in sd)
    model = ViNet(3, 32)
    decoder = {k: v.clone() for k, v in model.decoder.state_dict().items()}
    load_model_weights(model, path)
    for k, v in backbone.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(model.backbone.state_dict()[k], v), k
    assert all(torch.equal(model.decoder.state_dict()[k], v) for k, v in decoder.items())
