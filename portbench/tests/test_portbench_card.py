"""On the card, at the cells' own sizes: the control (one precision step
below bf16: the program's int8 path for ViNet, the int8-rounded reference
for AViNet, which has no int8 path), and in training the half-batch fault
too, fail the limits of ``correct`` that the program's own readings pass. Run on the card with
``python -m pytest --noconftest -p no:cacheprovider portbench/tests/test_portbench_card.py``
(``--noconftest``: the repository's root conftest imports JAX)."""

import pytest

from portbench import core


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _cell(name):
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    return core.resolve(spec, name, seed=0, seconds=30.0, trace=False)


@pytest.mark.card
def test_parity_int8_program_fails_the_limits(card):
    cell = _cell("vinet-dhf1k.parity")
    limits = core.load_json(core.BENCH_DIR / "limits" / f"{cell.name}.json")
    (row,) = core.driver(cell).control(cell, [2**31 + 17], 1)
    assert all(row["program"][k] <= v for k, v in limits.items()), row
    assert any(row["control_int8_program"][k] > v for k, v in limits.items()), row


@pytest.mark.card
def test_live_int8_reference_fails_the_limits(card):
    cell = _cell("avinet-stavis.live-cams")
    limits = core.load_json(core.BENCH_DIR / "limits" / f"{cell.name}.json")
    (row,) = core.driver(cell).control(cell, [2**31 + 19], 57)
    assert any(row["reference_int8"][k] > v for k, v in limits.items()), row


@pytest.mark.card
def test_train_int8_reference_and_faults_fail_the_limits(card):
    cell = _cell("avinet-stavis.train-b8")
    limits = core.load_json(core.BENCH_DIR / "limits" / f"{cell.name}.json")
    (row,) = core.driver(cell).control(cell, [2**31 + 23], 0)
    assert all(row["program"][k] <= v for k, v in limits.items()), row
    for reading in ("control_int8_reference", "fault_half_batch"):
        assert any(row[reading][k] > v for k, v in limits.items()), (reading, row)
