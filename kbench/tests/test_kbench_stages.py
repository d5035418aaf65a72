"""The stage-table parser reads what the program's StageTimer prints."""

import pytest

from kbench.trace import parse_stage_tables, stage_split


def _table(rows):
    from pykmer_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    timer.stages = rows
    return "stage timing (device strategy):\n" + timer.report() \
        + "\n  device peak memory: 123 bytes\n"


def test_parser_reads_every_row_of_every_table():
    rows = [("input read", 0.0012), ("decode + accumulate (pipelined)", 1.25),
            ("escape counts", 0.006), ("output alloc", 0.01), ("copy + unfold", 0.7),
            ("write + hash drain", 0.45), ("metadata", 0.002), ("verify", 0.6)]
    tables = parse_stage_tables("noise\n" + _table(rows) + _table(rows[:3]))
    assert len(tables) == 2
    assert [n for n, _ in tables[0]] == [n for n, _ in rows]
    assert [t for _, t in tables[0]] == pytest.approx([t for _, t in rows], abs=1e-4)
    split = stage_split(tables[0])
    assert split["accumulate"] == pytest.approx(1.25)
    assert split["tail"] == pytest.approx(0.006 + 0.01 + 0.7 + 0.45 + 0.002, abs=3e-4)
    assert split["verify"] == pytest.approx(0.6)


def test_a_table_without_an_accumulate_row_gives_nothing():
    assert stage_split([("input read", 0.1)]) is None
    assert parse_stage_tables("  orphan row    1.0 ms  10.0%\n") == []
