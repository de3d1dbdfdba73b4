"""3D head (`nn/alignnet.py` `AlignNet3D` without its temporal fusion):
device ms of the program's `model.alignnet` span less its
`model.temporal_fusion`, mean per request of the profiled stretch; twin
of `head3d_ms.serve`."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(_spans.minus(_spans.ms(r, ("model.alignnet",)),
                                    _spans.ms(r, ("model.temporal_fusion",)) or 0.0)
                       for r in _spans.stretch(records))
