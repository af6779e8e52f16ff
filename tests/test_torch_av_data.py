"""vinet_tpu_torch's audio-visual training data against vinet_tpu's, on a
STAViS layout of ``tests/fixtures.py::make_sound_dataset`` (one call per
name of ``AV_DATASETS`` into one root, 2 videos of 40 frames each at the
fixture's 64 x 96, some GT maps blacked out so that the zero-GT rejection
runs): ``SoundDataset`` items
in train mode (a random window whose last frame has nonzero GT, up to 100
draws) and test mode (windows strided 2T whose last GT is nonzero), with
and without audio, and ``ConcatDataset`` over the six, equal bit for bit for
the same generator; the Loader's batches with audio equal JAX's, in the same
order; the fold lists: DIEM's without a split, the other five with
``_{split}``. The train GT is resized to 224 x 384 by the port's numpy
bilinear and by JAX's OpenCV: bit for bit at this exact 3.5 x 4 upscale, as
on ``test_torch_data.py``'s DHF1K layout; at other scales the two lie within
1e-12 of each other in f64 (``test_torch_data.py``'s load_map test holds
them within 1e-6), which can move a near-zero value's last f32 bit."""

import numpy as np
import pytest
import torch
from PIL import Image

from tests.fixtures import make_sound_dataset
from tests.torch_port_util import TORCH_THREADS
from vinet_tpu.data import datasets as jd
from vinet_tpu.data import pipeline as jp
from vinet_tpu_torch.data import datasets as td
from vinet_tpu_torch.data import pipeline as tp

torch.set_num_threads(TORCH_THREADS)
T = 8


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("stavis")
    for i, ds in enumerate(td.AV_DATASETS):
        make_sound_dataset(root, dataset=ds, n_videos=2, n_frames=40, seed=i)
    # DIEM vid00: frames 9-30 without fixations (train draws ending there are
    # rejected, the test window ending at 8 stays and the one ending at 24 goes)
    black = Image.fromarray(np.zeros((64, 96), np.uint8))
    for f in range(9, 31):
        black.save(root / "annotations" / "DIEM" / "vid00" / "maps" / f"eyeMap_{f:05d}.jpg")
    return str(root)


def _assert_items_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _pair(root, ds, mode, use_sound):
    kw = dict(dataset_name=ds, split=1, mode=mode, use_sound=use_sound)
    return td.SoundDataset(root, T, **kw), jd.SoundDataset(root, T, **kw)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("ds", ["DIEM", "Coutrot_db1"])
def test_sound_dataset_items_equal_jax(root, ds, mode):
    port, ref = _pair(root, ds, mode, True)
    assert len(port) == len(ref) > 0
    assert port.list_num_frame == ref.list_num_frame
    for i in range(len(ref)):
        for seed in range(3):
            _assert_items_equal(port.get(i, np.random.default_rng((seed, i))),
                                ref.get(i, np.random.default_rng((seed, i))))
    item = port.get(0, np.random.default_rng(0))
    assert item["clip"].shape == (T, 224, 384, 3) and item["audio"].shape == (70560, 1)
    assert float(item["gt"].max()) > 0


def test_zero_gt_windows_are_rejected(root):
    port, ref = _pair(root, "DIEM", "test", False)
    assert ("vid00", 0) in port.list_num_frame and ("vid00", 16) not in port.list_num_frame
    assert ("vid01", 16) in port.list_num_frame
    train, _ = _pair(root, "DIEM", "train", False)
    for s in range(40):  # 22 of vid00's 33 starts end on a black map
        item = train.get(0, np.random.default_rng(s))
        assert "audio" not in item and float(item["gt"].max()) > 0


def test_concat_dataset_equals_jax(root):
    for mode in ("train", "test"):
        port = td.ConcatDataset([_pair(root, ds, mode, True)[0] for ds in td.AV_DATASETS])
        ref = jd.ConcatDataset([_pair(root, ds, mode, True)[1] for ds in td.AV_DATASETS])
        assert len(port) == len(ref) and list(port.offsets) == list(ref.offsets)
        for i in range(len(ref)):
            _assert_items_equal(port.get(i, np.random.default_rng((7, i))),
                                ref.get(i, np.random.default_rng((7, i))))


def test_loader_batches_with_audio_equal_jax(root):
    kw = dict(batch_size=3, shuffle=True, num_workers=2, seed=4)
    port = tp.Loader(td.ConcatDataset([_pair(root, ds, "train", True)[0]
                                       for ds in td.AV_DATASETS]), **kw)
    ref = jp.Loader(jd.ConcatDataset([_pair(root, ds, "train", True)[1]
                                      for ds in td.AV_DATASETS]), **kw)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_items_equal(g, w)
        assert g["audio"].shape == (3, 70560, 1)


def test_fold_lists_and_model_size(root, tmp_path):
    with pytest.raises(FileNotFoundError, match="Coutrot_db2_list_train_-1_fps.txt"):
        td.SoundDataset(root, T, dataset_name="Coutrot_db2", split=-1)
    assert len(td.SoundDataset(root, T, dataset_name="DIEM", split=-1)) == 2
    small = td.SoundDataset(root, T, dataset_name="AVAD", split=2, size=(64, 96))
    item = small.get(1, np.random.default_rng(0))
    assert item["clip"].shape == (T, 64, 96, 3) and item["gt"].shape == (64, 96)
