"""Command-line tools of the port, each run as `python -m
sanerf_hq_tpu_torch.tools.<name>`: `make_synth_scene` writes the rich or
clutter scene to disk as a dataset, `colmap2nerf` turns a COLMAP model
into `transforms.json`."""
