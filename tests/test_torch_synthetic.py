"""The port's synthetic fixtures (``vinet_tpu_torch/data/synthetic.py``)
against the JAX package's, bit for bit: the held-out videos every accuracy
number is scored on, and the DHF1K-layout blob dataset, file by file."""

import os

import numpy as np
import pytest

import vinet_tpu.data.synthetic as jax_syn
import vinet_tpu_torch.data.synthetic as syn

N_FRAMES = 8


def test_geometry_and_kinds():
    assert (syn.H, syn.W) == (jax_syn.H, jax_syn.W) == (224, 384)
    assert syn.FIXTURE_KINDS == jax_syn.FIXTURE_KINDS


@pytest.mark.parametrize("seed", [100, 7])
def test_make_eval_video_bit_for_bit(seed):
    frames, gts = syn.make_eval_video(n_frames=N_FRAMES, seed=seed)
    want_frames, want_gts = jax_syn.make_eval_video(n_frames=N_FRAMES, seed=seed)
    assert frames.dtype == np.uint8 and gts.dtype == np.float32
    assert frames.shape == (N_FRAMES, 224, 384, 3) and gts.shape == (N_FRAMES, 224, 384)
    assert np.array_equal(frames, want_frames) and np.array_equal(gts, want_gts)


@pytest.mark.parametrize("kind", jax_syn.FIXTURE_KINDS)
def test_make_fixture_video_bit_for_bit(kind):
    frames, gts = syn.make_fixture_video(kind, n_frames=N_FRAMES, seed=100)
    want_frames, want_gts = jax_syn.make_fixture_video(kind, n_frames=N_FRAMES, seed=100)
    assert np.array_equal(frames, want_frames) and np.array_equal(gts, want_gts)
    assert gts.max() > 0.5  # the salient content is in every video


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown fixture kind"):
        syn.make_fixture_video("spiral", n_frames=2)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_build_blob_dataset_file_by_file(tmp_path):
    got = syn.build_blob_dataset(str(tmp_path / "port"), n_train=1, n_val=1, n_frames=4)
    want = jax_syn.build_blob_dataset(str(tmp_path / "jax"), n_train=1, n_val=1, n_frames=4)
    assert [os.path.basename(p) for p in got] == ["train_data", "val_data"]
    for g, w in zip(got, want):
        names = _files(g)
        assert names == _files(w) and len(names) == 12  # images, maps, fixation x 4
        for name in names:
            with open(os.path.join(g, name), "rb") as a, open(os.path.join(w, name), "rb") as b:
                assert a.read() == b.read(), name
    # idempotent: an existing directory is left as it is
    before = os.path.getmtime(os.path.join(got[0], "001", "images", "0001.png"))
    syn.build_blob_dataset(str(tmp_path / "port"), n_train=1, n_val=1, n_frames=4)
    assert os.path.getmtime(os.path.join(got[0], "001", "images", "0001.png")) == before
