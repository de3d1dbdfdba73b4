"""Request handler (`entry.py` `ServeHandler`): the handler's own host ms
per request, the request less the session's `infer` (clocked at its
entry and return on the instance): the hand-off to the handler's worker
thread, the check, the upload of the raw frame and the readback of the
served grid. While `infer` returns only once the card's queue has
drained, the readback holds no wait for the card; mean per traced
request."""


def read(records):
    vals = records.get("handler_ms") or []
    return sum(vals) / len(vals) if vals else None
