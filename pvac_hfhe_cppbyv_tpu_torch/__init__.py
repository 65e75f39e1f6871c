"""pvac_hfhe_cppbyv_tpu_torch — PVAC-HFHE in PyTorch, with CUDA kernels.

The scheme over F_p, p = 2^127 - 1 (reference: the header-only C++17
library vasihh2009/pvac_hfhe_cppbyv, include/pvac/pvac.hpp), with its
device work in PyTorch and hand-written CUDA kernels for an NVIDIA H100
(sm_90a): the SHA-256 key derivation and the two AES-256-CTR keystreams
of the LPN PRF, the SHA-256-CTR draw streams of σ, and the σ row XOR.
Each kernel has a plain torch twin, used for CPU tensors.  The host keeps
layer bookkeeping, ct_mul's cross-product aggregation and serialization.

The port covers keygen, enc_value_batch, ct_add/sub/neg/scale/div-const,
ct_mul (up to the products the JAX package sends to its device grid) and
dec_value_batch; ``enable_device(pk, sk)`` attaches a
:class:`CudaEngine` so both device programs run on the card.
"""

from .params import Params, small_test_params
from .core.field import P
from .types import (
    Cipher, Dom, Layer, Nonce128, PubKey, RSeed, SecKey, Ubk,
    RRULE_BASE, RRULE_PROD, SGN_P, SGN_M,
)
from .crypto.keygen import keygen
from .ops.encrypt import enc_value_batch, combine_ciphers
from .ops.decrypt import dec_value_batch, layer_R
from .ops.arithmetic import (
    ct_add, ct_add_batch, ct_div_const, ct_mul, ct_mul_batch, ct_neg,
    ct_scale, ct_sub, ct_sub_batch,
)
from .io.serial import (
    load_cts, save_cts, load_sk, save_sk, load_pklite, save_pklite,
)
from .engine import CudaEngine, enable_device, disable_device
from .convert import keys_from_numpy

__all__ = [n for n in dir() if not n.startswith("_")]
