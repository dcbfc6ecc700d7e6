"""``program_spans.py`` on tiny cells on the CPU: the tracer on from the
end of set-up, its records in the result line, and nothing of it with
the tracer off.  No card here, so the metrics of the device's idle time
read nothing."""
import time

import pytest
import torch

from perfbench import program_spans
from vidgraph_tpu_torch.core import profiling

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4021


def _line(cell, tracer):
    clock = program_spans.TracerClock(0.0, time.perf_counter(), tracer)
    return program_spans.traced_line(cell, SEED, 0.3, tracer, clock, CPU)


@pytest.mark.parametrize("fixture", ["ingest_cell", "train_cell"])
@pytest.mark.parametrize("tracer", [True, False])
def test_traced_line_with_the_tracer_on_and_off(fixture, tracer, request):
    cell = request.getfixturevalue(fixture)
    line = _line(cell, tracer)
    kind = cell.traffic["kind"]
    assert line["correct"], line["checks"]
    assert profiling.span("x") is profiling.NULL_SPAN
    info = line["program_spans"]
    assert info["dropped"] == 0
    assert (info["records"] > 0) == tracer
    host = {"ingest": ["ingest.decode_host_ms_per_step",
                       "ingest.decode_cpu_share", "ingest.call_wait_ms"],
            "train": []}[kind]
    for name in program_spans.SPAN_METRICS[kind]:
        # the idle shares need device intervals: none on the CPU
        assert (name in line["metrics"]) == (tracer and name in host), name
    assert list(line)[-1] == "checks"


def test_a_dump_reads_back(train_cell, tmp_path):
    dump = str(tmp_path / "dump.json.gz")
    clock = program_spans.TracerClock(0.0, time.perf_counter(), True)
    program_spans.traced_line(train_cell, SEED, 0.3, True, clock, CPU, dump)
    read = program_spans.read_dump(dump)
    # no device intervals on the CPU: the whole window is one idle gap
    assert sum(n for _, n in read["idle_by_gap_us"].values()) == 1
    assert {"captioner.forward", "optim.update", "optim.clip",
            "optim.adamw"} <= set(read["median_ms"])
