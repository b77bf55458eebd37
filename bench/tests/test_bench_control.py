"""The control at a size a test run holds: the reference computed with
float8 e4m3 products, put in the program's place, lies farther from the
float32 reference than the program in its stated bfloat16 does, by at
least three times on the number that separates them (the output
head's first gradient in training, logits and caches in prefill).  On
the card the same control runs at each cell's own size
(``calibrate.py``; PERF.md gives the readings)."""
import pytest

import check
import harness
from helpers import BASE_CELL, PREFILL_CELL, reduced_conf, write_cell


@pytest.mark.parametrize("conf_name", ["nemotron-4-15b", "zamba2-2.7b"])
def test_training_control_is_farther(tmp_path, conf_name):
    harness.set_cache_dirs()
    cell = write_cell(tmp_path, "t", conf_name,
                      reduced_conf(conf_name, "bfloat16"),
                      **dict(BASE_CELL, batch=4, seq=256))
    drv = cell.mode.Driver(harness.Context(cell, 1, "cpu"))
    drv.setup()
    prog = drv.program_readings()
    drv.free()
    ref = drv.reference("f32")
    sound = check.train_numbers(prog, ref)
    control = check.train_numbers(drv.reference("fp8"), ref)
    assert control["head_grad_gap"] >= 3 * sound["head_grad_gap"], (
        sound, control)


def test_prefill_control_is_farther(tmp_path):
    harness.set_cache_dirs()
    cell = write_cell(tmp_path, "p", "nemotron-4-15b",
                      reduced_conf("nemotron-4-15b", "bfloat16"),
                      **PREFILL_CELL)
    drv = cell.mode.Driver(harness.Context(cell, 5, "cpu"))
    drv.setup()
    j, (logits, states) = drv.last
    sound = drv.compare(j, logits, states)
    control = drv.control(j)
    for name in ("logit_gap", "kv_gap"):
        assert control[name] >= 3 * sound[name], (sound, control)
