"""Process start to the first timed step: building, loading the scene,
the parameters, the checked steps and the warm-up."""
UNIT = "s"
LAYER = None
MOVES = None


def read(rec):
    return rec["setup_s"]
