"""On the card, at the cell's own size: the control of ``tased.forward-b8``
(the int8-rounded reference, one precision step below the program's bf16;
TASEDv2 has no int8 path) fails the limits of ``correct`` that the
program's own readings pass. Run on the card with
``python -m pytest --noconftest -p no:cacheprovider portbench/tests/test_portbench_card_tased.py``
(``--noconftest``: the repository's root conftest imports JAX)."""

import pytest

from portbench import core


@pytest.mark.card
def test_tased_int8_reference_fails_the_limits():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    cell = core.resolve(spec, "tased.forward-b8", seed=0, seconds=30.0, trace=False)
    limits = core.load_json(core.BENCH_DIR / "limits" / f"{cell.name}.json")
    (row,) = core.driver(cell).control(cell, [2**31 + 29], 6)
    assert all(row["program"][k] <= v for k, v in limits.items()), row
    assert any(row["reference_int8"][k] > v for k, v in limits.items()), row
