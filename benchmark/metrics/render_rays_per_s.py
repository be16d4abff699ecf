"""Every ray of every view rendered in the window over the window's
length, by the host's clock."""
UNIT = "rays/s"
LAYER = None
MOVES = None


def read(rec):
    w = rec["window"]
    return w["rays"] / w["seconds"] if w["seconds"] > 0 else None
