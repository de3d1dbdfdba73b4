"""Session (`serve/streaming.py` `TemporalSession`, `utils/graphs.py`): the
regions of a request that replayed as CUDA graphs, the program's
`graph_replays` counter, added where each region replays. Mean per
request of the profiled stretch; 0 where the program serves without
graphs (the single-frame server). A program without the graphs module
leaves nothing to read."""

import importlib.util

from perfbench.metrics import _spans


def read(records):
    try:
        if importlib.util.find_spec("veon_tpu_torch.utils.graphs") is None:
            return None
    except ImportError:
        return None
    return _spans.mean(r["counters"].get("graph_replays", 0) for r in _spans.stretch(records))
