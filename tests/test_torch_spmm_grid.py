"""The ELL gather-sum K7 (``csrc/onehot_spmm.cu``: a group of lanes a row,
vector loads) on the CPU:

* K7's plain version against the JAX package's ``onehot_spmm_t`` in
  interpret mode (jitted) on the layouts the kernel's edges create: rows
  whose bytes are not a multiple of 16 (18 and 14 columns, the residues of
  270 at f32 and bf16), an ELL wider than 32 entries (the kernel reads a
  row's indices 32 at a time at most), D = 1 (the transposed ELLs of
  x[senders], the incoming sum and the pooling), rows entirely sentinel or
  out of their pack, and the sign row present, absent, and alone;
  tolerances: rtol = atol = 1e-4 at f32 and for a bf16 source (exact at
  both types: only the order of the f32 sums differs), and for an f32
  source at mat_dtype bf16 the rule of tests/test_torch_layered_bf16.py
  (rel-L2 to JAX's bf16 result at most a quarter of JAX's own bf16-vs-f32
  distance and at most 5e-3, and unlike the port's f32 result);
* the wrapper's mirror of the kernel's launch plan (``launch_plan``: the
  chunk from the row width and the alignment of src and out, the lanes a
  row, the rows a block, the blocks) against the constants and the C
  interface of the CUDA source, and its rule case by case;
* the wrapper's one-pass check (``_fits``) against the errors that the
  full checks raise, and the autograd Function's check of the backward's
  ELL.

The kernel itself runs only on the card (tests/test_torch_cuda.py -k spmm).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu.ops.pallas_ops import build_idx_t, onehot_spmm_t
from cgr_mpnn_3d_tpu_torch.ops import _build
from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp

P, R, C = 3, 10, 12      # packs, output rows and source rows a pack
SENTINEL = P * C
BF16, F32 = "bfloat16", "float32"


def _ell(rng, D: int, sign: bool):
    """A [P*R, D] ELL array (and a [P*R] sign row): entries in the row's
    pack (repeats included), in another pack or the sentinel; rows 0, 3
    and 5 of every pack entirely sentinel, rows 1 and 6 only out of their
    pack; the sign row in the pack (row 3: a sign alone), the sentinel
    (rows 4, 5 and 8) or another pack's (row 9)."""
    idx = np.full((P * R, D), SENTINEL, np.int32)
    sgn = np.full((P * R,), SENTINEL, np.int32)
    for k in range(P):
        for r in range(R):
            row = k * R + r
            n = int(rng.integers(0, D + 1))
            local = rng.integers(0, C, n) + k * C
            other = rng.integers(0, C, n) + ((k + 1) % P) * C
            pick = rng.random(n)
            ent = np.where(pick < 0.7, local,
                           np.where(pick < 0.85, other, SENTINEL))
            idx[row, rng.permutation(D)[:n]] = ent
            if r in (0, 1, 3, 5, 6):
                idx[row] = SENTINEL
            if r in (1, 6):
                idx[row, :max(n, 1)] = ((k + 1) % P) * C
            sgn[row] = (SENTINEL if r in (4, 5, 8) else
                        int(rng.integers(0, C)) + ((k + 2) % P) * C
                        if r == 9 else int(rng.integers(0, C)) + k * C)
    return idx, (sgn if sign else None)


def _jax(src, idx, sign, mat):
    idx_t = build_idx_t(jnp.asarray(idx),
                        None if sign is None else jnp.asarray(sign), P)
    return onehot_spmm_t(idx_t, jnp.asarray(src), P, idx.shape[1],
                         sign is not None,
                         mat_dtype=jnp.bfloat16 if mat == BF16
                         else jnp.float32, interpret=True)


def _port(src, idx, sign, mat):
    return sp.onehot_spmm_ref(torch.from_numpy(src), torch.from_numpy(idx),
                              None if sign is None else
                              torch.from_numpy(sign), p=P, mat_dtype=mat)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# (columns, entries a row, with the sign row)
LAYOUTS = [(18, 40, True), (14, 40, False), (18, 1, False), (14, 7, True),
           (400, 33, True)]


@pytest.mark.parametrize("W,D,sign", LAYOUTS,
                         ids=[f"W{w}-D{d}{'-sign' if s else ''}"
                              for w, d, s in LAYOUTS])
@pytest.mark.parametrize("case", ["f32", "bf16 f32-src", "bf16 bf16-src"])
def test_plain_k7_matches_jax_on_the_kernels_edges(W, D, sign, case):
    rng = np.random.default_rng(W * 100 + D)
    idx, sgn = _ell(rng, D, sign)
    src = rng.standard_normal((P * C, W)).astype(np.float32)
    if case == "f32":
        got, want = _port(src, idx, sgn, F32), _jax(src, idx, sgn, F32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    elif case == "bf16 bf16-src":
        src16 = torch.from_numpy(src).bfloat16()
        got = sp.onehot_spmm_ref(src16, torch.from_numpy(idx),
                                 None if sgn is None else
                                 torch.from_numpy(sgn), p=P, mat_dtype=BF16)
        assert got.dtype == torch.float32
        want = _jax(jnp.asarray(src16.float().numpy(), jnp.bfloat16), idx,
                    sgn, BF16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    else:
        got, got32 = _port(src, idx, sgn, BF16), _port(src, idx, sgn, F32)
        want, want32 = _jax(src, idx, sgn, BF16), _jax(src, idx, sgn, F32)
        own = _rel_l2(want, want32)
        assert _rel_l2(got, want) <= min(0.25 * own, 5e-3)
        assert _rel_l2(got, got32) > 0.0
    # rows with no entry in their pack and no sign row are exact zeros
    empty = [k * R + r for k in range(P) for r in (0, 5)
             if sgn is None or not k * C <= sgn[k * R + r] < (k + 1) * C]
    assert not got[empty].any()


# -- the launch plan ----------------------------------------------------------

def _source() -> str:
    return (_build.CSRC / "onehot_spmm.cu").read_text()


def test_spmm_plan_constants_and_interface_match_the_kernel():
    src = _source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src)[1])
    assert const("kSpmmThreads") == sp.THREADS
    assert const("kSpmmLaneElems") == sp.LANE_ELEMS
    assert const("kSpmmMinLanes") == sp.MIN_LANES
    assert define("CGR_SPMM_VEC_BYTES") == sp.VEC_BYTES
    assert define("CGR_SPMM_LANES") == 0
    # the C functions take as many arguments as the wrapper types
    for fn, (argtypes, _) in sp._SIGNATURES.items():
        params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)[1]
        assert len(params.split(",")) == len(argtypes), fn


# (rows, W, src bytes, out bytes, src address, out address, forced load
# bytes, forced lanes) -> (elements a chunk, lanes, rows a block, blocks)
PLANS = [
    # 436 packs: pool forward, f32 and bf16 sources (16-byte loads)
    ((6976, 400, 4, 4, 0, 0, 16, 0), (4, 32, 8, 872)),
    ((6976, 400, 2, 4, 0, 0, 16, 0), (8, 32, 8, 872)),
    # x[senders] at F = 270: 1,080 and 540 bytes a row
    ((1024, 270, 4, 4, 0, 0, 16, 0), (2, 32, 8, 128)),
    ((1024, 270, 2, 4, 0, 0, 16, 0), (2, 32, 8, 128)),
    # a base off a 16-byte boundary takes a narrower load, never another
    # path
    ((64, 400, 4, 4, 4, 0, 16, 0), (1, 32, 8, 8)),
    ((64, 400, 4, 4, 8, 0, 16, 0), (2, 32, 8, 8)),
    ((64, 400, 2, 4, 2, 0, 16, 0), (1, 32, 8, 8)),
    # the output's alignment counts too (an f32 row of 8 bf16 values is
    # two 16-byte stores)
    ((64, 400, 2, 4, 0, 8, 16, 0), (2, 32, 8, 8)),
    # a bf16 d_src from an f32 gradient: 16-byte loads, 8-byte stores
    ((512, 400, 4, 2, 0, 0, 16, 0), (4, 32, 8, 64)),
    # narrow rows: a group of lanes sized to the row
    ((64, 16, 4, 4, 0, 0, 16, 0), (4, 4, 64, 1)),
    ((64, 40, 4, 4, 0, 0, 16, 0), (4, 4, 64, 1)),
    ((30, 18, 4, 4, 0, 0, 16, 0), (2, 4, 64, 1)),
    ((30, 14, 2, 4, 0, 0, 16, 0), (2, 4, 64, 1)),
    ((300, 7, 4, 4, 0, 0, 16, 0), (1, 4, 64, 5)),
    ((64, 160, 4, 4, 0, 0, 16, 0), (4, 16, 16, 4)),
    # wider than a warp holds in one pass: 32 lanes, passes
    ((64, 1000, 4, 4, 0, 0, 16, 0), (4, 32, 8, 8)),
    # the forced builds: 4-byte loads, one row a warp
    ((64, 400, 4, 4, 0, 0, 4, 0), (1, 32, 8, 8)),
    ((64, 400, 2, 4, 0, 0, 4, 0), (2, 32, 8, 8)),
    ((64, 16, 4, 4, 0, 0, 16, 32), (4, 32, 8, 8)),
]


@pytest.mark.parametrize("args,want", PLANS)
def test_spmm_launch_plan_rule(args, want):
    *shape, vec_bytes, lanes = args
    assert sp.launch_plan(*shape, vec_bytes=vec_bytes, lanes=lanes) == want


@pytest.mark.parametrize("W,src_size,out_size", [(400, 4, 4), (400, 2, 4),
                                                 (270, 4, 4), (270, 2, 4),
                                                 (18, 4, 2), (7, 2, 4)])
def test_spmm_plan_covers_every_column_once(W, src_size, out_size):
    """Each pass of a group covers lanes x LANE_ELEMS / chunk chunks, the
    chunk divides the row, its load is at most 16 bytes, and every
    address the plan accepts is aligned to it."""
    for src_ptr in range(0, 32, 2 if src_size == 2 else 4):
        for out_ptr in range(0, 32, out_size):
            vec, lanes, per_block, blocks = sp.launch_plan(
                100, W, src_size, out_size, src_ptr, out_ptr)
            assert W % vec == 0 and vec * src_size <= 16
            assert src_ptr % (vec * src_size) == 0
            assert out_ptr % min(vec * out_size, 16) == 0
            assert lanes * per_block == sp.THREADS
            assert blocks * per_block >= 100 > (blocks - 1) * per_block
            per_pass = lanes * (sp.LANE_ELEMS // vec)
            assert lanes == 32 or per_pass >= W // vec


# -- the one-pass check -------------------------------------------------------

def _ok():
    src = torch.zeros((P * C, 8))
    idx = torch.full((P * R, 3), SENTINEL, dtype=torch.int32)
    sign = torch.full((P * R,), SENTINEL, dtype=torch.int32)
    return src, idx, sign


BAD = [
    ("src not contiguous", lambda s, i, g: (s.t().contiguous().t(), i, g, P,
                                            F32),
     ValueError, "src is not contiguous"),
    ("idx int64", lambda s, i, g: (s, i.long(), g, P, F32), TypeError,
     "idx is torch.int64"),
    ("sign of another length", lambda s, i, g: (s, i, g[1:], P, F32),
     ValueError, "sign has shape"),
    ("rows not in packs", lambda s, i, g: (s, i, g, 4, F32), ValueError,
     "must split into p=4 packs"),
    ("bf16 src at f32", lambda s, i, g: (s.bfloat16(), i, g, P, F32),
     TypeError, "src is torch.bfloat16"),
    ("unknown mat_dtype", lambda s, i, g: (s, i, g, P, "float16"),
     ValueError, "unsupported mat_dtype"),
    ("1-d idx", lambda s, i, g: (s, i[:, 0], g, P, F32), ValueError,
     "must be 2-d"),
    ("sign int64", lambda s, i, g: (s, i, g.long(), P, F32), TypeError,
     "sign is torch.int64"),
]


@pytest.mark.parametrize("name,make,exc,match", BAD, ids=[b[0] for b in BAD])
def test_one_pass_check_refuses_what_the_full_check_refuses(name, make, exc,
                                                            match):
    src, idx, sign, p, md = make(*_ok())
    assert not sp._fits(src, idx, sign, p, sp._MAT.get(md))
    with pytest.raises(exc, match=match):
        sp._refuse(src, idx, sign, p, md)


@pytest.mark.parametrize("md", [F32, BF16])
def test_one_pass_check_takes_what_the_kernel_takes(md):
    src, idx, sign = _ok()
    mat = sp._MAT[md]
    assert sp._fits(src, idx, sign, P, mat)
    assert sp._fits(src, idx, None, P, mat)
    # [rows, 1] views of a 1-d index array (senders[:, None])
    assert sp._fits(src, idx[:, 0].contiguous()[:, None], None, P, mat)
    assert sp._fits(src.bfloat16(), idx, sign, P, mat) == (md == BF16)


def test_backward_ell_is_checked_in_the_forward():
    src, idx, sign = _ok()
    bwd = torch.full((P * C, 2), SENTINEL, dtype=torch.int32)
    sp._check_bwd(src, bwd, None)
    sp._check_bwd(src, bwd, torch.zeros(P * C, dtype=torch.int32))
    with pytest.raises(ValueError, match="one per row of src"):
        sp._check_bwd(src, bwd[1:], None)
    with pytest.raises(ValueError, match="one per row of src"):
        sp._check_bwd(src, bwd, torch.zeros(P * C + 1, dtype=torch.int32))
    with pytest.raises(TypeError, match="idx_bwd is torch.int64"):
        sp._check_bwd(src, bwd.long(), None)
