"""Device time of the encoder's global-attention blocks a cache view:
the CUDA-event times of the `sanerf.sam.encode.global` spans (4 in
ViT-H) under each `sanerf.sam.view` of the span slice, summed, the median
over the slice's views."""
from benchmark.harness import spans

UNIT = "ms"
LAYER = "encoder"
MOVES = "view_ms.p95"


def install(hooks):
    spans.install(hooks)


def read(rec):
    return spans.median_device_ms(rec, "sanerf.sam.view",
                                  "sanerf.sam.encode.global")
