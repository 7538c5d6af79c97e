"""The ``ladder_escalations`` reader on hand-made fit records."""

from h100bench.lib import cell


def test_ladder_escalations_reads_the_fit_report():
    for name in ("ladder_escalations.fit.sparse", "ladder_escalations.fit.dense"):
        read, variant = cell.reader(name)
        recs = [{"report": {"ladder_escalations": k}} for k in (0, 3, 6)]
        assert read(cell.Context(records=recs), variant) == 3.0
        assert read(cell.Context(records=[{"wall_s": 1.0}]), variant) is None  # no report
        assert read(cell.Context(records=[]), variant) is None
