"""The slice as a whole on the CPU: the port's evaluation CLIs against the
JAX package's on the same data (``tests/fixtures.py``), ``diem_val`` against
the JAX metrics on the port's own predictor, ``export_checkpoint`` against
the JAX package's export of the same trees, and ``utils/runtime.py``."""

import os
import re
from os.path import join

import numpy as np
import pytest
import torch

import vinet_tpu.metrics.emd as jax_emd
from tests.fixtures import make_dhf1k, make_sound_dataset
from tests.torch_port_util import FIXTURE, TORCH_THREADS, build_jax_emd, fixture_trees
from vinet_tpu_torch.io.images import load_map, save_map

torch.set_num_threads(TORCH_THREADS)
ALL_METRICS = "cc,sim,kldiv,nss,aucj,aucb,sauc,ig,emd"


@pytest.fixture(scope="module", autouse=True)
def jax_native_emd(tmp_path_factory):
    """JAX's EMD on its own native solver, built in a copy (never ``make``
    beside the JAX tests)."""
    lib = build_jax_emd(tmp_path_factory.mktemp("jax_emd"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_emd, "_load_native", lambda: lib)
        yield


def _pred_from_gt(gt: np.ndarray, rng) -> np.ndarray:
    """A prediction that is near the GT but not it: shifted, noisy."""
    return np.roll(gt, (2, -3), axis=(0, 1)) + 0.2 * rng.random(gt.shape)


@pytest.fixture(scope="module")
def dhf1k(tmp_path_factory):
    """A DHF1K-layout GT set (2 videos x 12 frames at 64 x 96, two fixations
    a frame) and PNG predictions for it."""
    root = tmp_path_factory.mktemp("eval_dhf1k")
    gt = make_dhf1k(str(root / "gt"), n_videos=2, n_frames=12)
    rng = np.random.default_rng(0)
    for v in ("001", "002"):
        os.makedirs(root / "pred" / v)
        for f in sorted(os.listdir(join(gt, v, "maps"))):
            save_map(_pred_from_gt(load_map(join(gt, v, "maps", f)), rng),
                     str(root / "pred" / v / f))
    return str(root / "pred"), gt


def _stdout(main, argv, capsys) -> list:
    capsys.readouterr()
    rc = main(argv)
    assert rc in (0, None)
    return capsys.readouterr().out.splitlines()


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
@pytest.mark.parametrize("metrics,seed", [(ALL_METRICS, 0), ("cc,sauc,ig", 3)])
def test_evaluate_dhf1k_stdout_matches_jax(dhf1k, capsys, metrics, seed):
    from vinet_tpu.cli.evaluate_dhf1k import main as jax_main
    from vinet_tpu_torch.cli.evaluate_dhf1k import main

    pred, gt = dhf1k
    argv = ["--pred_path", pred, "--gt_path", gt, "--metrics", metrics, "--seed", str(seed)]
    got = _stdout(main, argv, capsys)
    assert got == _stdout(jax_main, argv, capsys)
    overall = dict(l.split(": ") for l in got[got.index("=== overall (per-video means) ===") + 1:])
    assert sorted(overall) == sorted(metrics.split(","))
    assert all(np.isfinite(float(x)) for x in overall.values())


@pytest.fixture(scope="module")
def stavis(tmp_path_factory):
    """A STAViS-layout set (2 videos x 12 frames at 64 x 96: eyeMap jpgs,
    fixMap .mat) and jpg predictions named as the frames."""
    root = tmp_path_factory.mktemp("eval_diem")
    data, names = make_sound_dataset(str(root / "data"), n_videos=2, n_frames=12)
    rng = np.random.default_rng(1)
    for v in names:
        os.makedirs(root / "pred" / v)
        maps = join(data, "annotations", "DIEM", v, "maps")
        for f in sorted(os.listdir(maps)):
            save_map(_pred_from_gt(load_map(join(maps, f)), rng),
                     str(root / "pred" / v / ("img_" + f.split("_")[-1])))
    return str(root / "pred"), data


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
@pytest.mark.parametrize("per_frame", [False, True])
def test_eval_diem_stdout_matches_jax(stavis, capsys, per_frame):
    from vinet_tpu.cli.eval_diem import main as jax_main
    from vinet_tpu_torch.cli.eval_diem import main

    pred, data = stavis
    argv = ["--pred_path", pred, "--annot_path", join(data, "annotations", "DIEM"),
            "--annot_file", join(data, "fold_lists", "DIEM_list_test_fps.txt"), "--emd"]
    argv += ["--per_frame"] if per_frame else []
    got = _stdout(main, argv, capsys)
    assert got == _stdout(jax_main, argv, capsys)
    assert [l.split(":")[0] for l in got[got.index("=== overall ===") + 1:]] == \
        ["cc", "sim", "nss", "aucj", "sauc", "emd"]
    one = _stdout(main, argv + ["--max_videos", "1"], capsys)
    assert one == _stdout(jax_main, argv + ["--max_videos", "1"], capsys)
    assert sum(l.startswith("video ") for l in one) == 1


DIEM_ARGS = ["--use_sound", "False", "--clip_size", "8", "--input_h", "64", "--input_w", "96",
             "--dtype", "float32", "--window_batch", "4"]


def test_diem_val_prints_the_jax_metrics_of_its_maps(tmp_path, capsys):
    """diem_val's averages equal, to the printed digits, JAX's metric
    functions on the port's SlidingWindowPredictor maps (that predictor is
    held against JAX's in tests/test_torch_engine.py)."""
    from scipy.io import loadmat

    from vinet_tpu.metrics import auc_judd, cc_score, nss_score, similarity_score
    from vinet_tpu_torch.cli.common import build_model
    from vinet_tpu_torch.cli.diem_val import build_parser, main
    from vinet_tpu_torch.inference import SlidingWindowPredictor
    from vinet_tpu_torch.io.images import load_frame

    data, (name,) = make_sound_dataset(str(tmp_path / "data"), n_videos=1, n_frames=16)
    argv = ["--path_data", data, "--device", "cpu", *DIEM_ARGS]
    got = _stdout(main, argv, capsys)

    args = build_parser().parse_args(argv)
    pred = SlidingWindowPredictor(build_model(args), clip_size=8, batch=4, dtype=torch.float32,
                                  device="cpu")
    fdir = join(data, "video_frames", "DIEM", name)
    clip = np.stack([load_frame(join(fdir, f), size=(64, 96))[0] for f in sorted(os.listdir(fdir))])
    annot = join(data, "annotations", "DIEM", name)
    vals = {k: [] for k in ("sim", "cc", "nss", "aucj")}
    for i, m in pred.predict_video(clip, out_size=(64, 96)):
        gt = load_map(join(annot, "maps", "eyeMap_%05d.jpg" % (i + 1)))
        fix = np.asarray(loadmat(join(annot, "fixMap_%05d.mat" % (i + 1)))["eyeMap"], np.float64)
        for k, v in (("sim", similarity_score(m, gt)), ("cc", cc_score(m, gt)),
                     ("nss", nss_score(m, fix)), ("aucj", auc_judd(m, fix))):
            vals[k].append(v)
    assert len(vals["cc"]) == 16
    means = [f"{k}: {np.mean(v):.4f}" for k, v in vals.items()]
    assert got[0] == f"processing {name}"
    assert got[-10:] == ["=== per-frame averages ===", *means, "=== per-video averages ===",
                         *means]


def test_use_sound_raises(tmp_path):
    """diem_val --use_sound True builds AViNet and, asked for the card where
    there is none, raises before reading the data (it runs on the CPU in
    test_use_sound_matches_the_predictor)."""
    from vinet_tpu_torch.cli.diem_val import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    data, _ = make_sound_dataset(str(tmp_path / "data"), n_videos=1, n_frames=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--path_data", data, "--device", "cuda", "--use_sound", "True"])


def test_use_sound_matches_the_predictor(tmp_path, capsys):
    """diem_val --use_sound True on the CPU: the per-frame averages of the AV
    predictor's maps with the video's audio excerpts."""
    from vinet_tpu_torch.cli.common import build_model
    from vinet_tpu_torch.cli.diem_val import build_parser, main
    from vinet_tpu_torch.data.audio import audio_excerpt, build_audio_index
    from vinet_tpu_torch.inference import SlidingWindowPredictor
    from vinet_tpu_torch.io.images import load_frame
    from vinet_tpu_torch.metrics import cc_score

    data, (name,) = make_sound_dataset(str(tmp_path / "data"), n_videos=1, n_frames=63,
                                       size=(32, 32))
    argv = ["--path_data", data, "--device", "cpu", "--use_sound", "True", "--clip_size", "32",
            "--input_h", "32", "--input_w", "32", "--dtype", "float32", "--window_batch", "16"]
    assert main(argv) == 0
    got = capsys.readouterr().out.splitlines()
    args = build_parser().parse_args(argv)
    pred = SlidingWindowPredictor(build_model(args), batch=16, dtype=torch.float32, device="cpu")
    info = build_audio_index([name], {name: 63}, {name: 10.0}, join(data, "video_audio", "DIEM"),
                             gt_root=join(data, "annotations", "DIEM"))[name]
    fdir = join(data, "video_frames", "DIEM", name)
    clip = np.stack([load_frame(join(fdir, f), size=(32, 32))[0] for f in sorted(os.listdir(fdir))])
    annot = join(data, "annotations", "DIEM", name)
    cc = [cc_score(m, load_map(join(annot, "maps", "eyeMap_%05d.jpg" % (i + 1))))
          for i, m in pred.predict_video(clip, out_size=(32, 32),
                                         audio_fn=lambda s: audio_excerpt(info, 32, s))]
    assert len(cc) == 63 and f"cc: {np.mean(cc):.4f}" in got


@pytest.mark.parametrize("cli", ["evaluate_dhf1k", "eval_diem", "diem_val", "export_checkpoint"])
def test_help(cli, capsys):
    import importlib

    mod = importlib.import_module(f"vinet_tpu_torch.cli.{cli}")
    with pytest.raises(SystemExit) as e:
        mod.build_parser().parse_args(["--help"])
    assert e.value.code == 0
    assert "vinet_tpu_torch.cli." + cli in capsys.readouterr().out


def test_export_of_the_fixture_equals_jax_export(tmp_path, capsys):
    """The port's export of the fixture = the JAX package's
    trees_to_torch_state_dict of the same trees, key for key and value for
    value in f32 (no JAX init: the trees come from the .npz)."""
    from vinet_tpu.io.export import trees_to_torch_state_dict
    from vinet_tpu_torch.cli.export_checkpoint import main

    def leaves(node):
        return [a for v in node.values() for a in (leaves(v) if isinstance(v, dict) else [v])]

    params, state = fixture_trees()
    out = str(tmp_path / "fixture.pt")
    assert main(["--file_weight", FIXTURE, "--output", out]) == 0
    n = sum(a.size for a in leaves(params))  # what the JAX CLI counts: params, not state
    assert capsys.readouterr().out.strip() == f"exported {n} params to {out}"
    got = torch.load(out, weights_only=True)
    want = trees_to_torch_state_dict(params, state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        t = got[k]
        assert t.is_contiguous() and t.device.type == "cpu", k
        if k.endswith("num_batches_tracked"):
            assert t.dtype == torch.int64 and int(t) == 0 == int(v), k
        else:
            assert t.dtype == torch.float32 and np.array_equal(t.numpy(), v), k


def test_export_from_a_train_checkpoint(tmp_path):
    """--checkpoint_dir: a ViNet(3, 8) TrainState saved by io/checkpoint.py
    exports its model (latest step or --step), strict-loads into a fresh
    ViNet(3, 8), and a model built from other flags fails."""
    from vinet_tpu_torch.cli.export_checkpoint import main
    from vinet_tpu_torch.io.checkpoint import save_checkpoint
    from vinet_tpu_torch.models import ViNet
    from vinet_tpu_torch.training.trainer import init_train_state

    torch.manual_seed(3)
    ts = init_train_state(ViNet(3, 8), 1e-4)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, ts, step=1)
    with torch.no_grad():
        for p in ts.model.parameters():
            p.add_(0.25)
    ts.model.decoder.convtsp1[0].weight.data.mul_(-1.0)
    for m in ts.model.modules():  # a trained BatchNorm has counted its batches
        if isinstance(m, torch.nn.BatchNorm3d):
            m.num_batches_tracked.fill_(7)
    save_checkpoint(ck, ts, step=2)

    for step, want_shift in ((None, True), (1, False)):
        out = str(tmp_path / f"export_{step}.pt")
        argv = ["--clip_size", "8", "--checkpoint_dir", ck, "--output", out]
        assert main(argv + (["--step", str(step)] if step else [])) == 0
        sd = torch.load(out, weights_only=True)
        fresh = ViNet(3, 8)
        fresh.load_state_dict(sd, strict=True)
        for k, v in ts.model.state_dict().items():
            if k.endswith("num_batches_tracked"):
                assert int(sd[k]) == 0, k
            elif want_shift:
                assert torch.equal(sd[k], v), k
        if not want_shift:
            assert not torch.equal(sd["decoder.convtsp1.0.weight"],
                                   ts.model.state_dict()["decoder.convtsp1.0.weight"])

    with pytest.raises(SystemExit) as e:  # flags that build another model
        main(["--clip_size", "16", "--checkpoint_dir", ck, "--output", str(tmp_path / "x.pt")])
    assert e.value.code == 2
    with pytest.raises(SystemExit):  # exactly one source
        main(["--checkpoint_dir", ck, "--file_weight", FIXTURE, "--output", "x.pt"])


def test_num_params_and_profiling(tmp_path):
    from vinet_tpu_torch.models import ViNet
    from vinet_tpu_torch.utils import enable_profiling, num_params

    lin = torch.nn.Linear(4, 3)
    tied = torch.nn.Sequential(lin, torch.nn.ReLU(), lin)  # one storage, counted once
    assert num_params(tied) == 15
    assert num_params(ViNet(3, 8)) == sum(p.numel() for p in ViNet(3, 8).parameters())
    with enable_profiling(str(tmp_path / "prof")):
        torch.relu(torch.randn(64, 64)).sum()
    trace = tmp_path / "prof" / "trace.json"
    assert trace.exists() and "relu" in trace.read_text()


@pytest.mark.slow
def test_diem_val_matches_the_jax_cli(tmp_path, capsys):
    """JAX's diem_val CLI and the port's on the same fixture weights and data
    (ViNet(3, 32) at 64 x 96, f32): every printed number within 2e-3."""
    from vinet_tpu.cli.diem_val import main as jax_main
    from vinet_tpu_torch.cli.diem_val import main

    data, _ = make_sound_dataset(str(tmp_path / "data"), n_videos=1, n_frames=64)
    argv = ["--path_data", data, "--file_weight", FIXTURE, "--use_sound", "False",
            "--input_h", "64", "--input_w", "96", "--dtype", "float32", "--window_batch", "8"]
    got = _stdout(main, argv + ["--device", "cpu"], capsys)
    want = _stdout(jax_main, argv, capsys)
    num = re.compile(r"-?\d+\.\d+")
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):  # the same lines, each number within 2e-3
        assert num.sub("#", g) == num.sub("#", w)
        for a, b in zip(num.findall(g), num.findall(w)):
            assert abs(float(a) - float(b)) <= 2e-3, (g, w)
