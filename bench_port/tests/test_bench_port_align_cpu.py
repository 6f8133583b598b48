"""A whole align run on the CPU at a small size: the stage-5.4 CLI on the
plain torch DPs, four pairs in buckets of two, a pyramid of two levels
and more; the plain reference must give the same alignments, and each
fault of the timed path must make the run incorrect."""

import copy

import pytest

from bench_port import harness, run


def small_cell():
    cell = copy.deepcopy(harness.load_cell("laser.align_bucket8"))
    cell["traffic_data"]["sizes"] = [[150, 140], [130, 160], [170, 150], [120, 125]]
    cell["stage_args"] = ["-a", "6", "--pair_batch", "2", "--max_size_full_dp", "40"]
    cell["align_options"].update(pair_batch=2, max_size_full_dp=40)
    cell["device"] = "cpu"
    return cell


def test_small_run_agrees_with_reference():
    correct, record, metrics = run.run_cell(small_cell(), 2**31 + 5, 0.01, False, 0.0,
                                            require_card=False)
    checks = {c.name: c.value for c in record.checks}
    assert correct, checks
    assert checks["cost_gap_max"] < 1e-4, checks
    assert set(metrics) == {"align_pairs_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", ["row_altered", "slot_altered", "half_batch"])
def test_small_run_fails_when_broken(fault):
    correct, record, _ = run.run_cell(small_cell(), 7, 0.01, False, 0.0, faults=(fault,),
                                      require_card=False)
    assert not correct, [(c.name, c.value) for c in record.checks]


def test_small_control_reads_above_the_program(tmp_path):
    """bf16 operands in the reference move the costs far past the program's
    float32 rounding."""
    from bench_port.drivers import align_stage

    readings = align_stage.control(small_cell(), 2**31 + 5, tmp_path)
    assert readings["cost_gap_max"] > 1e-4, readings
