"""The plain reference against the program's CPU path at each
configuration's REDUCED size, in float32: the loss, every leaf's first
gradient and change after three AdamW steps, the prefill's logits and
caches.  With the same seed the reference draws the program's WTA-CRS
plans again (``reference/plans.py``), so the sampled gradients agree
too; where two rows' probabilities tie within rounding (zamba2's
normed inputs at these widths) a plan can differ in a row, which moves
a gradient norm by well under 1 %."""
import pytest

from helpers import BASE_CELL, PREFILL_CELL, reduced_conf, run, write_cell


@pytest.mark.parametrize("conf_name,estimator,grad", [
    ("nemotron-4-15b", "wta_crs", 1e-5),
    ("nemotron-4-15b", "exact", 1e-5),
    ("zamba2-2.7b", "exact", 1e-4),
    ("zamba2-2.7b", "wta_crs", 1e-2),
])
def test_train_steps_match(tmp_path, conf_name, estimator, grad):
    cell = write_cell(tmp_path, "t", conf_name, reduced_conf(conf_name),
                      **dict(BASE_CELL, estimator=estimator,
                             limits={"loss_gap": 1e-5, "grad_gap": grad,
                                     "change_gap": 1e-2}))
    rec = run(cell)
    assert rec["correct"], rec["numbers"]


def test_prefill_matches(tmp_path):
    cell = write_cell(tmp_path, "p", "nemotron-4-15b",
                      reduced_conf("nemotron-4-15b"), **PREFILL_CELL)
    rec = run(cell)
    assert rec["correct"], rec["numbers"]
    assert rec["attempted"] == rec["steps"] * 4 and rec["failed"] == 0
