"""Device time of SAM's image encoder a cache view, from the program's
own `sanerf.sam.encode` span (harness/spans.py): the CUDA-event time of
the encode under each `sanerf.sam.view` of the span slice, the median
over the slice's views."""
from benchmark.harness import spans

UNIT = "ms"
LAYER = "encoder"
MOVES = "view_ms.p95"


def install(hooks):
    spans.install(hooks)


def read(rec):
    return spans.median_device_ms(rec, "sanerf.sam.view", "sanerf.sam.encode")
