"""Set-up (`entry.py` `serve_entry`): seconds of the program's own
`setup.serve_entry` span, the serving model and text tower, the rig's
presort and the warm-up request, of the run's last `serve_entry`."""

from perfbench.metrics import _spans


def read(records):
    tracing = _spans.tracer()
    spans = [s for s in tracing.setup() if s["name"] == "setup.serve_entry"] if tracing else []
    return spans[-1]["host_s"] if spans else None
