"""pvac_hfhe_cppbyv_tpu_torch — PVAC-HFHE in PyTorch, with CUDA kernels.

The scheme over F_p, p = 2^127 - 1 (reference: the header-only C++17
library vasihh2009/pvac_hfhe_cppbyv, include/pvac/pvac.hpp), with its
device work in PyTorch and hand-written CUDA kernels for an NVIDIA H100
(sm_90a): the SHA-256 key derivation and the two AES-256-CTR keystreams
of the LPN PRF, the SHA-256-CTR draw streams of σ, and the σ row XOR.
Each kernel has a plain torch twin, used for CPU tensors.  The host keeps
layer bookkeeping, ct_mul's cross-product aggregation and serialization;
products too large for the host aggregator run as a dense-grid int8
convolution on the device (mulgrid.py).

The port covers keygen, enc_value / enc_value_batch / enc_fp_depth(_batch)
/ enc_zero_depth, ct_add/sub/neg/scale/div-const, ct_mul at any depth
(a product past 2^21 edges keeps a recipe-backed VirtualSigma),
dec_value / dec_value_batch, recrypt, commit_ct, the text codec and the
metrics; ``enable_device(pk, sk)`` attaches a :class:`CudaEngine` so the
device programs run on the card.
"""

from .params import Params, small_test_params
from .core.field import P
from .types import (
    Cipher, Dom, EvalKey, Layer, Nonce128, PubKey, RSeed, SecKey, Ubk,
    VirtualSigma, RRULE_BASE, RRULE_PROD, SGN_P, SGN_M,
)
from .crypto.keygen import keygen
from .crypto.matrix import apply_perm_sigma, ubk_apply
from .ops.encrypt import (
    combine_ciphers, compact_edges, compact_layers, enc_fp_depth,
    enc_fp_depth_batch, enc_value, enc_value_batch, enc_value_depth,
    enc_zero_depth, guard_budget, sigma_density,
)
from .ops.decrypt import dec_value, dec_value_batch, layer_R
from .ops.arithmetic import (
    ct_add, ct_add_batch, ct_div_const, ct_mul, ct_mul_batch, ct_neg,
    ct_scale, ct_sub, ct_sub_batch,
)
from .ops.recrypt import make_evalkey, ct_recrypt, sigma_needs_balance
from .ops.commit import commit_ct
from .utils.text import enc_text, dec_text, pack_15_bytes_to_fp, unpack_fp_to_15_bytes
from .utils.metrics import (
    dump_metrics, sigma_shannon, agg_layer_gsum, check_mul_gsum_all,
)
from .io.serial import (
    load_cts, save_cts, load_sk, save_sk, load_pklite, save_pklite,
)
from .engine import CudaEngine, enable_device, disable_device
from .convert import keys_from_numpy

__all__ = [n for n in dir() if not n.startswith("_")]
