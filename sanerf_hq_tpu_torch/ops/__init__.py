from .trunc_exp import trunc_exp, safe_trunc_exp
from .sh import sh_encode
from .contraction import contract, uncontract
from .freq import freq_encode, freq_output_dim
from .encoding import get_encoder
from .ray import near_far_from_aabb, spacing_fn, spacing_fn_inv, sample_pdf
from .composite import compute_weights, distort_loss, proposal_loss
