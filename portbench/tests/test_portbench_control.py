"""The control of each check, on the card at a size a test run holds: the
plain reference computed in TF32 (the precision below the
configurations' float32 with TF32 off) put in the program's place reads
far above the program's own run on the numbers the check compares, and,
for the classifier, fails the configuration's own limits
(``control_correct`` false) where the program's run passes them.  The
decoder's limits were set at its 30 layers of width 4096, where its
control reads 4x above them (PERF.md); at the two layers here it reads
under them.
``portbench/control.py`` runs the same at the cells' own sizes (PERF.md
gives those readings).  The decoder runs two layers at width 1024 over a
vocabulary of 16384: at the smoke width of 64, TF32's rounding over sums
of 64 terms reads within 3x of float32's."""
import pytest

from portbench import harness, spec
from conftest import write_root

NUMBERS = {"albert-backlog-long": ("ent1_gap",), "deepseek7b-decode-ee": ("tok_gap", "ent_gap")}
FAILS_LIMITS_HERE = {"albert-backlog-long"}
WIDER = {"deepseek_7b": dict(d_model=1024, n_heads=8, n_kv_heads=8, head_dim=128, d_ff=2816, vocab_size=16384)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(NUMBERS))
def test_control_reads_above_the_program(tmp_path, cuda, cell):
    root = write_root(tmp_path, WIDER)
    r = harness.run_cell(spec.load_cell(cell, root), 2 ** 31 + 5, 2.0, False, "cuda", control=True)
    assert r["correct"], r["checks"]
    if cell in FAILS_LIMITS_HERE:
        assert r["control_correct"] is False, r["control_checks"]
    prog, ctrl = r["readings"], r["control_readings"]
    assert max(ctrl[n] for n in NUMBERS[cell]) > 3 * max(max(prog[n] for n in NUMBERS[cell]), 1e-7)
