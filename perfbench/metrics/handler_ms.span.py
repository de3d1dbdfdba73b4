"""Request handler (`entry.py` `ServeHandler`), from the program's own
spans: host ms of `serve.request` (the caller's thread, from the call to
its return) less `serve.compute` (the session's or frame server's
`infer` on the worker): the hand-off to the worker, the check, the
upload of the raw frame and the readback of the served grid. Mean per
request of the profiled stretch; twin of `handler_ms.serve`."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(_spans.minus(_spans.ms(r, ("serve.request",), "host_ms"),
                                    _spans.ms(r, ("serve.compute",), "host_ms"))
                       for r in _spans.stretch(records))
