"""The metrics that read the program's spans and counters, on a made-up
snapshot of two steps; each gives None with no snapshot or no trace."""

import pytest

from benchmark import harness, program_trace

MS = 1_000_000


def _span(name, step, host, dev0, dev1, parent=None):
    return {"name": name, "parent": parent, "step": step, "thread": 1,
            "host_begin_ns": host, "host_end_ns": host + 1,
            "device_begin_ns": dev0, "device_end_ns": dev1}


SNAPSHOT = {
    "spans": [
        _span("train_step", 0, 0, 2 * MS, 30 * MS),
        _span("pool", 0, 1, 3 * MS, 4 * MS, 0),
        _span("backward", 0, 2, 10 * MS, 25 * MS, 0),
        _span("pool.grad", 0, 3, 11 * MS, 13 * MS),
        _span("train_step", 1, 40 * MS, 46 * MS, 70 * MS),
        _span("pool", 1, 41 * MS, 47 * MS, 48 * MS, 4),
        _span("backward", 1, 42 * MS, 50 * MS, 59 * MS, 4),
        _span("pool.grad", 1, 43 * MS, 51 * MS, 52 * MS),
        # a span the card never reached: left out
        _span("pool.grad", 1, 44 * MS, None, None),
    ],
    "counters": {"kernel.cmul_contract": 34, "coord_conv.k2": 4},
    "steps": 2,
    "anchor": {"device": "cuda:0", "host_ns": 0},
}
WANT = {"pool_ms_per_step": (1 + 2 + 1 + 1) / 2,
        "backward_ms_per_step": (15 + 9) / 2,
        "launch_queue_ms": (2 + 6) / 2,
        "kernel_calls_per_step": 17.0}
RUN = {"trace": {"steps": 2}}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reads_a_snapshot(monkeypatch, name):
    monkeypatch.setattr(program_trace, "snapshot", lambda: SNAPSHOT)
    got = harness.load_module("metrics", name).read(RUN)
    assert got == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_none_without_a_snapshot_or_a_trace(monkeypatch, name):
    read = harness.load_module("metrics", name).read
    monkeypatch.setattr(program_trace, "snapshot", lambda: None)
    assert read(RUN) is None
    monkeypatch.setattr(program_trace, "snapshot", lambda: SNAPSHOT)
    assert read({"trace": None}) is None
    empty = dict(SNAPSHOT, spans=[])
    monkeypatch.setattr(program_trace, "snapshot", lambda: empty)
    assert read(RUN) is None


def test_no_kernel_calls_read_nought(monkeypatch):
    snap = dict(SNAPSHOT, counters={"coord_conv.cudnn": 12})
    monkeypatch.setattr(program_trace, "snapshot", lambda: snap)
    read = harness.load_module("metrics", "kernel_calls_per_step").read
    assert read(RUN) == 0.0


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    from spectralae_torch.core import profiling
    monkeypatch.delattr(profiling, "snapshot")
    assert program_trace.snapshot() is None
