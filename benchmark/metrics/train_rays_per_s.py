"""Every ray trained in the window over the window's length, by the host's
clock; the window's time on the EMA and the error-map rebuild counts, the
rays those renders use do not."""
UNIT = "rays/s"
LAYER = None
MOVES = None


def read(rec):
    w = rec["window"]
    return w["rays"] / w["seconds"] if w["seconds"] > 0 else None
