"""Device time of the field's hash encodes inside a training step, from
the program's own `sanerf.encode` spans (harness/spans.py): for each step
of the slice, the CUDA-event time of every encode under that step's
`sanerf.step` span, forward and, where the table learns, backward (from
the encode output's gradient to the table's accumulated gradient, so
work autograd runs between the two counts); the median over the
slice's steps."""
from benchmark.harness import spans

UNIT = "ms"
LAYER = "encoder"
MOVES = "train_rays_per_s"


def install(hooks):
    spans.install(hooks)


def read(rec):
    return spans.median_device_ms(rec, "sanerf.step", "sanerf.encode")
