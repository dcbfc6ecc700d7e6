"""A run with the timed path broken underneath must come out not
``correct``, and the control (the reference in fp8 in the program's
place) must read above the cell's limits: each on tiny cells on the CPU,
driving the harness past its look for a card."""
import time

import pytest
import torch

from perfbench import run as bench
from perfbench.harness.faults import planted
from perfbench.harness.trace import SetupClock

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


def _run(cell, keep=False):
    out = cell.harness.run(cell, SEED, 0.5, False,
                           SetupClock(0.0, time.perf_counter()), CPU,
                           keep=keep)
    return out, bench.result_line(cell, out, False, CPU)


def test_sound_runs_are_correct(ingest_cell, train_cell):
    for cell in (ingest_cell, train_cell):
        _, line = _run(cell)
        assert line["correct"], line["checks"]
        assert list(line)[-1] == "checks"


def test_a_token_altered_where_it_is_produced(ingest_cell):
    with planted("token_altered"):
        _, line = _run(ingest_cell)
    assert not line["correct"]
    assert line["checks"]["token_gap"]["value"] > \
        line["checks"]["token_gap"]["limit"]


def test_half_of_a_call_left_out(ingest_cell):
    """At a batch of 4 chunks a call, as the stream engine sends them."""
    ingest_cell.traffic.update(chunks_per_call=4, pool_chunks=6,
                               sample_rows_per_call=2)
    with planted("half_call"):
        _, line = _run(ingest_cell)
    assert not line["correct"]
    assert line["checks"]["served_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults(train_cell, fault):
    with planted(fault):
        _, line = _run(train_cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fixture", ["ingest_cell", "train_cell"])
def test_control_fails(fixture, request):
    cell = request.getfixturevalue(fixture)
    out, _ = _run(cell, keep=True)
    low = cell.harness.control(cell, SEED, out, CPU)
    assert any(low[k] > cell.limits[k] for k in low), low
