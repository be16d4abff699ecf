"""Plain reference of what the benchmark's cells time, in plain PyTorch.

It follows the published algorithm of SANeRF-HQ's two fields (the MLP
field with CP line features, the hash-grid field of the reference's
`nerf/network.py`), their proposal sampler, compositing, losses and Adam,
and imports nothing of the program under test: no kernel, no module of the
port, no JAX.  The benchmark hands it the inputs it made itself (the scene,
the parameters from the seed, the program's random source) and it works
out everything else again.

Every matrix product goes through `common.mm`, whose `mode` names the
precision of its operands: 'fp32', 'tf32', 'bf16' or 'fp8' (e4m3 with a
per-tensor scale); the sums are fp32.  The precision a configuration
states is its reference's mode; the mode one step below is its control.
"""
