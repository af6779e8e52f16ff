"""No process the benchmark starts holds JAX or the JAX package, and the
plain reference holds nothing of the program either. Module names are
compared by their whole top-level name: ``vinet_tpu_torch`` is the port,
``vinet_tpu`` the JAX package."""

import json
import subprocess
import sys

from portbench import core

RUN_SMALL = """
import json, sys, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(2)
from portbench import core
from portbench.tests.helpers import small_cell
import portbench.run as run
for name in {names!r}:
    out = run.measure(small_cell(name))
    assert out["correct"], out
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.counts, portbench.frames
import portbench.reference.models, portbench.reference.post, portbench.reference.weights
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=core.ROOT, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_runs_load_no_jax():
    tops = _tops(RUN_SMALL.format(root=str(core.ROOT),
                                  names=["vinet-dhf1k.parity", "avinet-stavis.live-cams"]))
    assert "vinet_tpu_torch" in tops  # the program did run
    assert not tops & set(core.FORBIDDEN), tops & set(core.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = _tops(REFERENCE_ONLY.format(root=str(core.ROOT)))
    assert not tops & {*core.FORBIDDEN, "vinet_tpu_torch"}


def test_forbidden_names_are_whole():
    sys.modules.setdefault("vinet_tpu_torch_lookalike", sys)
    try:
        found = core.forbidden_modules()
        assert "vinet_tpu_torch_lookalike" not in found
        assert not [m for m in found if m.split(".")[0] == "vinet_tpu_torch"]
    finally:
        del sys.modules["vinet_tpu_torch_lookalike"]
