"""The port's CLIs on 2 gloo ranks on the CPU, the counterpart of the JAX
package's slow ``tests/test_multihost.py``, and their parallel flags.

One world of 2 spawned processes, brought up through the JAX package's
VINET_* variables (``tests/torch_port_util.py::rank_clis``):

- ``cli.train --multihost`` (visual ViNet, clip 8, batch 1 a process, one
  step with validation, on a synthetic DHF1K directory): both ranks print
  the same ``avg_loss`` (rtol 1e-6) for the train epoch and the
  validation, and only rank 0 writes the best model and the checkpoint
  (each rank is given its own paths);
- ``cli.generate_result --data_parallel`` (clip 8, 32 x 32, f32): rank 0
  writes the maps of a one-process run here, rank 1 none. Each rank runs 2
  windows of a batch of 4, and the CPU's f32 convolutions round by the
  batch they get (``tests/test_torch_parallel_infer.py`` holds the f32 maps
  within 1e-4), so a map's 8-bit quantisation may flip by one level: at
  most one level, on at most 1e-3 of the pixels (12 of 122,880 here). On
  the card, at world 1, ``chip_smoke.py`` requires them byte for byte;
- the new flags (``--data_parallel``, ``--stream_parallel``,
  ``--multihost``, ``--model_axis``) parse with the JAX CLIs' defaults.
"""

import os

import numpy as np
import pytest
import torch

from tests.fixtures import make_dhf1k
from tests.torch_port_util import TORCH_THREADS, World, rank_clis
from vinet_tpu_torch.cli.generate_result import main as generate_main

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("clis")
    make_dhf1k(root / "train", n_videos=2, n_frames=20, size=(64, 96))
    make_dhf1k(root / "val", n_videos=1, n_frames=20, size=(64, 96), seed=1)
    train_args = ["--train_path_data", str(root / "train"), "--val_path_data", str(root / "val"),
                  "--device", "cpu", "--clip_size", "8", "--batch_size", "1", "--no_epochs", "1",
                  "--max_steps_per_epoch", "1", "--no_workers", "1", "--log_interval", "1"]
    generate_args = ["--path_indata", str(root / "val"), "--clip_size", "8", "--input_h", "32",
                     "--input_w", "32", "--dtype", "float32", "--device", "cpu",
                     "--window_batch", "4"]
    world = World(rank_clis, 2, train_args, generate_args, str(root),
                  workdir=tmp_path_factory.mktemp("world"))
    assert generate_main(generate_args + ["--save_path", str(root / "one")]) == 0
    return {"ranks": world.results(), "root": root}


def _losses(stdout: str, what: str) -> float:
    line = [ln for ln in stdout.splitlines() if f"{what}] avg_loss" in ln][-1]
    return float(line.split(":")[1].split()[0].rstrip(","))


def test_train_multihost_ranks_agree_and_rank_0_writes(run):
    r0, r1 = run["ranks"]
    assert r0["train_rc"] == r1["train_rc"] == 0
    for what in ("train", "val"):
        np.testing.assert_allclose(_losses(r0["train"], what), _losses(r1["train"], what),
                                   rtol=1e-6)
    root = run["root"]
    assert "save" in r0["train"] and "save" not in r1["train"]
    assert (root / "best0.pt").exists() and not (root / "best1.pt").exists()
    assert os.listdir(root / "ck0") and not (root / "ck1").exists()


def test_generate_data_parallel_writes_the_one_process_maps(run):
    root = run["root"]
    assert all(r["generate_rc"] == 0 for r in run["ranks"])
    want = sorted(os.listdir(root / "one" / "001"))
    assert len(want) == 20 and sorted(os.listdir(root / "maps0" / "001")) == want
    diff = np.stack([np.abs(_png(root / "maps0" / "001" / n) - _png(root / "one" / "001" / n))
                     for n in want])
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).sum())
    assert not os.listdir(root / "maps1" / "001")


def _png(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im).astype(np.int16)


@pytest.mark.parametrize("cli, argv, flags", [
    ("generate_result", ["--path_indata", "d", "--save_path", "o"], ["--data_parallel"]),
    ("generate_result_audio_visual", ["--path_data", "d", "--save_path", "o"],
     ["--data_parallel"]),
    ("serve", ["--path_indata", "d", "--save_path", "o"], ["--stream_parallel"]),
    ("train", ["--train_path_data", "d"], ["--multihost", "--model_axis", "2"]),
])
def test_parallel_flags_parse_as_jax(cli, argv, flags):
    import importlib

    jax_p = importlib.import_module(f"vinet_tpu.cli.{cli}").build_parser()
    port_p = importlib.import_module(f"vinet_tpu_torch.cli.{cli}").build_parser()
    names = [f.lstrip("-") for f in flags if f.startswith("--")]
    for extra in ([], flags):
        want, got = vars(jax_p.parse_args(argv + extra)), vars(port_p.parse_args(argv + extra))
        assert {k: got[k] for k in names} == {k: want[k] for k in names}, extra
