"""``python -m vinet_tpu_torch.cli.train`` on the CPU, on a synthetic DHF1K
directory of ``tests/fixtures.py`` (frames resized to 224 x 384, clip 8,
batch 2): one step with validation and a checkpoint, then --resume goes on
from its step; the best model is a reference-named state_dict that
``load_weights`` and ``generate_result --file_weight`` read, or at a path
ending in .npz the JAX package's trees, which the port and JAX read;
--streaming_ft leaves the BatchNorm statistics as they were. What the CLI does not do
stops at startup: --multihost with --model_axis 2 (the JAX CLI's message), a
model axis of 2 in a world of one process (create_mesh's), --streaming_ft
with --use_sound True.

On a six-dataset STAViS layout (one ``make_sound_dataset`` call per name of
``AV_DATASETS`` into one root, frames decoded at the model's 64 x 96):
``--dataset SoundDataset --use_sound True --use_transformer True`` (AViNet,
clip 32) trains, validates on the six test folds, checkpoints and resumes,
and ``generate_result_audio_visual --file_weight`` reads its best model;
``--dataset SoundDataset`` without sound trains visual ViNet on the same
layout."""

import os

import pytest
import torch

from tests.fixtures import make_dhf1k, make_sound_dataset
from tests.torch_port_util import TORCH_THREADS
from vinet_tpu_torch.cli.train import main as train_main
from vinet_tpu_torch.data.datasets import AV_DATASETS
from vinet_tpu_torch.io.checkpoint import latest_step
from vinet_tpu_torch.io.weights import load_weights
from vinet_tpu_torch.models import ViNet

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    make_dhf1k(root / "train", n_videos=2, n_frames=20, size=(64, 96))
    make_dhf1k(root / "val", n_videos=1, n_frames=20, size=(64, 96), seed=1)
    return root


def _args(root, *extra):
    return ["--train_path_data", str(root / "train"), "--val_path_data", str(root / "val"),
            "--device", "cpu", "--clip_size", "8", "--batch_size", "2", "--no_epochs", "1",
            "--max_steps_per_epoch", "1", "--no_workers", "2", *extra]


def test_train_validates_checkpoints_and_resumes(dirs, capsys):
    ck, best = dirs / "ck", dirs / "best.pt"
    common = ("--checkpoint_dir", str(ck), "--model_val_path", str(best))
    assert train_main(_args(dirs, *common)) == 0
    assert latest_step(str(ck)) == 1
    out = capsys.readouterr().out
    assert "[ 0, val] avg_loss" in out and "save" in out
    assert train_main(_args(dirs, *common, "--resume", "--lr_sched", "true",
                            "--bn_recal", "1")) == 0
    assert "resumed from step 1" in capsys.readouterr().out
    assert latest_step(str(ck)) == 2

    model = ViNet(3, 8)
    model.load_state_dict(load_weights(str(best)), strict=True)


def test_best_model_feeds_generate_result(dirs, tmp_path):
    from vinet_tpu_torch.cli.generate_result import main as generate_main

    best = dirs / "best_gen.pt"
    assert train_main(_args(dirs, "--model_val_path", str(best))) == 0
    out = tmp_path / "maps"
    assert generate_main(["--path_indata", str(dirs / "val"), "--save_path", str(out),
                          "--file_weight", str(best), "--clip_size", "8", "--input_h", "32",
                          "--input_w", "32", "--dtype", "float32", "--device", "cpu"]) == 0
    assert len(os.listdir(out / "001")) == 20


def test_npz_best_model_is_the_jax_tree_both_packages_read(dirs):
    """--model_val_path x.npz writes the JAX package's trees (what its CLI
    writes there): the port's load_weights and JAX's load_npz_tree (template
    from eval_shape) both read it, and it holds the epoch's checkpointed
    model, value for value."""
    import shutil

    import jax
    import numpy as np

    from vinet_tpu.io.convert import load_npz_tree
    from vinet_tpu.models import ViNet as JaxViNet
    from vinet_tpu_torch.io.checkpoint import restore_raw
    from vinet_tpu_torch.io.weights import from_jax_trees

    ck, best = dirs / "ck_npz", dirs / "best.npz"
    try:
        assert train_main(_args(dirs, "--checkpoint_dir", str(ck), "--model_val_path",
                                str(best))) == 0
        want = restore_raw(str(ck))["model"]
        got = load_weights(str(best))
        shapes = jax.eval_shape(JaxViNet(3, 8).init, jax.random.PRNGKey(0))
        jax_sd = from_jax_trees(*jax.tree_util.tree_map(
            np.asarray, load_npz_tree(str(best), *shapes)))
    finally:  # a full-width model and its Adam state: some 500 MB
        shutil.rmtree(ck, ignore_errors=True)
        best.unlink(missing_ok=True)
    model = ViNet(3, 8)
    model.load_state_dict(got, strict=True)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v) and torch.equal(jax_sd[k], v), k


def test_streaming_ft_keeps_bn_statistics(dirs):
    start, ft = dirs / "start.pt", dirs / "ft.pt"
    torch.manual_seed(1)
    torch.save(ViNet(3, 8).state_dict(), str(start))
    assert train_main(_args(dirs, "--streaming_ft", "--ft_chunk", "16", "--ft_windows", "4",
                            "--load_weight", str(start), "--model_val_path", str(ft))) == 0
    before, after = torch.load(str(start)), torch.load(str(ft))
    assert all(torch.equal(before[k], after[k]) for k in before if "running" in k)
    assert any(not torch.equal(before[k], after[k]) for k in before if k.endswith("weight"))


@pytest.mark.parametrize("extra, message", [
    (("--multihost", "--model_axis", "2"), "--multihost"),
    (("--model_axis", "2"), "--model_axis"),
    (("--use_sound", "True", "--streaming_ft"), "--streaming_ft fine-tunes visual ViNet only"),
    (("--grad_accum", "3"), "divisible"),
    (("--streaming_ft", "--ft_chunk", "12"), "--ft_chunk"),
])
def test_what_is_not_ported_stops_at_startup(dirs, extra, message):
    with pytest.raises(SystemExit, match=message):
        train_main(_args(dirs, *extra))


@pytest.mark.parametrize("extra, message", [
    (("--multihost", "--model_axis", "2"), "^--multihost with --model_axis>1 is unsupported"),
    (("--model_axis", "2"), "not divisible by model=2"),
])
def test_parallel_flags_stop_with_jax_messages(dirs, extra, message):
    """The JAX CLI's startup refusal of --multihost with a model axis, and
    create_mesh's of a model axis that one process cannot hold."""
    with pytest.raises(SystemExit, match=message):
        train_main(_args(dirs, *extra))


def test_cuda_without_a_card_raises(dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(dirs)
    args[args.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(args)


@pytest.fixture(scope="module")
def stavis(tmp_path_factory):
    root = tmp_path_factory.mktemp("stavis")
    for i, ds in enumerate(AV_DATASETS):  # DIEM long enough for generation (2T - 1)
        make_sound_dataset(root, dataset=ds, n_frames=64 if ds == "DIEM" else 40, seed=i)
    return root


def _av_args(root, *extra):
    return ["--dataset", "SoundDataset", "--split", "1", "--train_path_data", str(root),
            "--device", "cpu", "--input_h", "64", "--input_w", "96", "--batch_size", "2",
            "--no_epochs", "1", "--max_steps_per_epoch", "1", "--no_workers", "2", *extra]


def test_av_train_validates_checkpoints_resumes_and_feeds_generation(stavis, tmp_path, capsys):
    from vinet_tpu_torch.cli.generate_result_audio_visual import main as generate_main

    ck, best = tmp_path / "ck", tmp_path / "best.pt"
    common = ("--use_sound", "True", "--use_transformer", "True", "--clip_size", "32",
              "--checkpoint_dir", str(ck), "--model_val_path", str(best))
    assert train_main(_av_args(stavis, *common)) == 0
    out = capsys.readouterr().out
    assert "[ 0, val] avg_loss" in out and "save" in out and latest_step(str(ck)) == 1
    assert train_main(_av_args(stavis, *common, "--resume", "--bn_recal", "1")) == 0
    assert "resumed from step 1" in capsys.readouterr().out and latest_step(str(ck)) == 2

    sd = torch.load(str(best), weights_only=True)
    assert sd["audionet.conv1.weight"].dim() == 4 and "transformer.pos_encoder.pe" in sd
    maps = tmp_path / "maps"
    assert generate_main(["--path_data", str(stavis), "--save_path", str(maps),
                          "--file_weight", str(best), "--use_sound", "True",
                          "--use_transformer", "True", "--input_h", "64", "--input_w", "96",
                          "--dtype", "float32", "--device", "cpu", "--streaming"]) == 0
    assert len(os.listdir(maps / "vid00")) == 64


def test_sound_dataset_without_sound_trains_vinet(stavis, tmp_path, capsys):
    best = tmp_path / "best.pt"
    assert train_main(_av_args(stavis, "--clip_size", "8", "--model_val_path", str(best))) == 0
    assert "[ 0, val] avg_loss" in capsys.readouterr().out
    ViNet(3, 8).load_state_dict(load_weights(str(best)), strict=True)
