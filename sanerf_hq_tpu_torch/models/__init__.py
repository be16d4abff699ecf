from .mlp import MLP
from .mlp_field import MLPField, FreqMLP, make_field
from .convert import params_from_jax
