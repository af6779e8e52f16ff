"""Small CPU cells for the benchmark's tests: the committed cells' files with
the model input and the maps cut to a few pixels, short videos and few
streams, so that a whole run (set-up, window, check) takes seconds. The
program runs in f32 there (the CPU's bf16 convolutions are slow, and the
limits of ``correct`` were read at the cells' own sizes on the card)."""

from __future__ import annotations

from portbench import core

SMALL = {"input_h": 32, "input_w": 64, "frame_h": 36, "frame_w": 64, "dtype": "float32"}
TRAFFIC = {"vinet-dhf1k.parity": {"lengths": [70, 80], "window_batch": 4, "sample_maps": 4},
           "avinet-stavis.live-cams": {"streams": 2, "sample_maps": 4},
           "avinet-stavis.train-b8": {"batch": 2, "pool": 6, "warm_steps": 1}}
SECONDS = {"vinet-dhf1k.parity": 1.0, "avinet-stavis.live-cams": 5.0}


def small_cell(name: str, seed: int = 2**31 + 5, root=core.ROOT, trace: bool = False,
               spec: dict | None = None) -> core.Cell:
    spec = spec or core.load_json(root / "BENCHMARK.json")
    cell = core.resolve(spec, name, root=root, seed=seed, seconds=SECONDS.get(name, 1.0),
                        trace=trace)
    cell.device = "cpu"
    cell.config.update(SMALL)
    cell.traffic.update(TRAFFIC.get(name, {}))
    return cell
