"""The comparison's control and its negative checks, on the card at each
cell's own size (on a machine with an H100: ``python3 -m pytest
bench_port/tests/test_bench_port_card.py -q -s``).

- The control: the plain reference put in the program's place and
  computed one precision step below the configuration's (fp8 products for
  bf16) must fail the cell's limit, on three seeds.
- The faults: a run whose timed path is broken underneath must come out
  not correct. Stage 5.3: every eighth row of each chunk altered where it
  is produced; half of each chunk's rows left out, the other half's copied
  in; on several cards, the rows of every card but the first never
  gathered. Stage 5.4: one alignment cost of every pair altered where the
  pyramid returns it, or of one slot of each bucket alone; half of a
  bucket's pairs given the other half's results.
"""

import pytest

from bench_port import harness, run
from bench_port.drivers import align_stage, embed_stage

CONTROL_SEEDS = (2147483901, 2147483902, 2147483903)
EMBED_CELLS = ("laser.embed_plenary", "sonar.embed_plenary")


@pytest.mark.card
@pytest.mark.parametrize("name", EMBED_CELLS)
def test_control_fails_the_limit(card, name, tmp_path):
    cell = harness.load_cell(name)
    limit = cell["check"]["row_rel_gap_max"]
    gaps = [embed_stage.control(cell, seed, tmp_path / str(seed)) for seed in CONTROL_SEEDS]
    print(f"control {name}: row_rel_gap_max {gaps} against limit {limit}")
    assert min(gaps) > limit


@pytest.mark.card
def test_align_control_fails_a_limit(card, tmp_path):
    cell = harness.load_cell("laser.align_bucket8")
    readings = [align_stage.control(cell, seed, tmp_path / str(seed)) for seed in CONTROL_SEEDS]
    print(f"control laser.align_bucket8: {readings} against limits {cell['check']}")
    assert all(r["cost_gap_max"] > cell["check"]["cost_gap_max"] for r in readings)


@pytest.mark.card
@pytest.mark.parametrize("name,fault", [(c, f) for c in EMBED_CELLS + ("laser.align_bucket8",)
                                        for f in ("row_altered", "half_batch")]
                         + [("laser.align_bucket8", "slot_altered"),
                            ("laser.embed_plenary_4chip", "no_exchange")])
def test_broken_path_is_not_correct(card, name, fault):
    import torch

    cell = harness.load_cell(name)
    if torch.cuda.device_count() < cell["chips"]:
        pytest.skip(f"{name} needs {cell['chips']} cards")
    correct, record, _ = run.run_cell(name, 2147483911, 1.0, False, 0.0, faults=(fault,),
                                      require_card=False)
    print(f"fault {name} {fault}: " + ", ".join(f"{c.name} {c.value}" for c in record.checks))
    assert not correct
