"""Offline dry run of the port's released-weights runbook,
``vinet_tpu_torch/tools/validate_released.py`` (the counterpart of
``tests/test_runbook.py`` for ``scripts/validate_released.sh``).

A reference-format ``ViNet_DHF1K.pt`` written by the port's exporter
(``io/export.py``, a seeded ViNet(3, 8)) and a synthetic 2-video DHF1K val
set go through the runbook end to end, named by its environment variables
as a user would stage them: parity and ``--streaming`` maps for every frame
and the four scores of each, parseable and finite, at clip 8, f32, on the
CPU.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_validate_released_dry_run(tmp_path):
    import torch

    from tests.fixtures import make_dhf1k
    from vinet_tpu_torch.io.export import export_torch_checkpoint
    from vinet_tpu_torch.models import ViNet

    torch.manual_seed(0)
    ckpt = str(tmp_path / "ViNet_DHF1K.pt")
    export_torch_checkpoint(ckpt, ViNet(3, 8))
    val = str(tmp_path / "val")
    make_dhf1k(val, n_videos=2, n_frames=18, seed=3)
    out = str(tmp_path / "out")
    env = dict(os.environ, VINET_CKPT=ckpt, DHF1K_VAL=val)
    r = subprocess.run(
        [sys.executable, "-m", "vinet_tpu_torch.tools.validate_released", "--out", out,
         "--clip_size", "8", "--device", "cpu",
         "--gen_args", "--dtype float32 --window_batch 8 --input_h 64 --input_w 96"],
        capture_output=True, text=True, timeout=1800, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for sub in ("maps", "maps_streaming"):
        for vid in ("001", "002"):
            assert len(os.listdir(os.path.join(out, sub, vid))) == 18, (sub, vid)
    for fname in ("scores_parity.txt", "scores_streaming.txt"):
        text = open(os.path.join(out, fname)).read()
        overall = text.split("=== overall")[-1]
        got = dict(re.findall(r"\b(cc|sim|nss|aucj)\b\s*:\s*([-\d.naN]+)", overall))
        assert set(got) == {"cc", "sim", "nss", "aucj"}, (fname, text[-800:])
        assert all(v.lower() not in ("nan", "-nan") for v in got.values()), (fname, got)


def test_validate_released_refuses_missing_files(tmp_path):
    from vinet_tpu_torch.tools.validate_released import main

    with pytest.raises(SystemExit, match="downloads nothing"):
        main(["--ckpt", str(tmp_path / "absent.pt"), "--val", str(tmp_path),
              "--out", str(tmp_path / "out"), "--device", "cpu"])
