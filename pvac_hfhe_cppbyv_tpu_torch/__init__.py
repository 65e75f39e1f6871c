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

The port covers the whole public API of the JAX package: keygen,
enc_value / enc_value_batch / enc_fp_depth(_batch) / enc_zero_depth,
ct_add/sub/neg/scale/div-const, ct_mul at any depth (a product past 2^21
edges keeps a recipe-backed VirtualSigma), dec_value / dec_value_batch,
recrypt, commit_ct, the text codec and the metrics; the scalar reference
API (prf_R / prf_R_noise, prg_choose_k, sigma_from_H, prf_noise_delta,
Shake256 / XofShake, core.ct_safe); byte-exact .ct / sk.bin / pk.bin /
pklite.bin / params.json I/O; the :class:`Client` / :class:`Evaluator`
split (service.py); the application circuits (models/circuits.py);
profiling helpers (utils/profiling.py); and the CLI
(``python -m pvac_hfhe_cppbyv_tpu_torch [--device cpu] ...``).
``keygen``, ``load_pklite``, ``load_pk``, ``keys_from_numpy`` and
``Client.generate`` attach a :class:`CudaEngine` on the card unless given
``device="cpu"``, so the device programs run there;
``enable_device(pk, sk)`` attaches one by hand.  ``fieldv`` holds field
limbs in torch tensors and ``bitvec`` packs host numpy words.
"""

PVAC_TPU_VERSION = "0.1.0"
# Reference library version constants (include/pvac/pvac.hpp:27-37).
PVAC_REF_VERSION = "0.1.0"

from .config import get_debug_level, set_debug_level
from .params import Params, params_from_json, params_to_json, small_test_params
from .core.field import (
    P, MASK63, fp_from_u64, fp_from_words, fp_to_words,
    fp_add, fp_sub, fp_neg, fp_mul, fp_inv, fp_pow, rand_fp_nonzero,
)
from .core import fieldv
from .core import bitvec
from .core.random import csprng_bytes, csprng_u64
from .core.hash import sha256, Shake256, XofShake
from .types import (
    Cipher, Dom, EvalKey, Layer, Nonce128, PubKey, RSeed, SecKey, Ubk,
    VirtualSigma, RRULE_BASE, RRULE_PROD, SGN_P, SGN_M, sgn_val, make_nonce128,
)
from .crypto.keygen import keygen, factor_small
from .crypto.lpn import (
    derive_aes_key, lpn_make_ybits, prf_R, prf_R_noise, prf_R_batch,
    fnv1a_domain, hash_to_fp_nonzero,
)
from .crypto.matrix import (
    prg_choose_k, gen_ubk_public, apply_perm_sigma, gen_H, prg_layer_ztag,
    sigma_from_H, ubk_apply,
)
from .ops.encrypt import (
    plan_noise, prf_noise_delta, combine_ciphers, compact_edges,
    compact_layers, enc_fp_depth, enc_fp_depth_batch, enc_value,
    enc_value_batch, enc_value_depth, enc_zero_depth, guard_budget,
    sigma_density,
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
    load_cts, save_cts, load_sk, save_sk, load_pk, save_pk, load_pklite,
    save_pklite, load_params, save_params, MAGIC_CT, MAGIC_SK, MAGIC_PK, VER,
)
from .engine import CudaEngine, enable_device, disable_device
from .convert import keys_from_numpy

from .service import Client, Evaluator

__all__ = [n for n in dir() if not n.startswith("_")]
