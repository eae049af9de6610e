"""The host side of the axis-DFT kernels' precision tiers
(mvtb_tpu_torch/ops/pallas_dft.py): the shared bf16 split, the tier names,
the route each (body, tier) takes, and the packed core-matrix layout that
the tensor-core body (``csrc/axis_dft.cu``) reads its matrices from.

These run on the CPU: the layout is rebuilt element by element from the
packed tensor and compared bit for bit with ``dft.device_mats`` split by
``dft.split_bf16``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.ops.pallas_dft import _split_bf16
from mvtb_tpu_torch.ops import dft as tdft
from mvtb_tpu_torch.ops import fused_plane as tplane
from mvtb_tpu_torch.ops import pallas_dft as tpdft

CPU = torch.device("cpu")
# (label, body, matrix kind, inverse): the lane and sublane matrix sets of
# the tensor-core bodies (r2c lane: the half matrix of rdft_nd; c2c: the
# Gauss matrices; r2c sublane: the full matrix of dft_nd on a real input;
# c2r lane: the completion matrix of irdft_nd_real; c2r sublane: the full
# inverse matrix of idft_nd_real)
KINDS = [("r2c lane", "r2c", "half", False), ("c2c lane", "c2c", "gauss", True),
         ("c2c sublane", "c2c", "gauss", False), ("r2c sublane", "r2c", "full", False),
         ("c2r lane", "c2r", "half_inv", True), ("c2r sublane", "c2r", "full", True)]


def _int_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _unpack(flat, body, n_in, n_out, parts):
    """Rebuild (term, part) matrices of (rows, n_in) from the packed layout,
    reading element (r, k) where the kernel's descriptors read it: group
    r // GR, step k // 16, term, part, core matrix (r % GR // 8, k % 16 // 8),
    row r % 8, column k % 8."""
    terms, nch, rows = tpdft.mat_layout(body, n_out)
    GR = 80 * nch
    Rp, Kp = -(-rows // GR) * GR, -(-n_in // 16) * 16
    assert flat.numel() == terms * parts * Rp * Kp
    blocks = flat.view(Rp // GR, Kp // 16, terms, parts, GR // 8, 2, 8, 8)
    r = torch.arange(Rp).view(-1, 1)
    k = torch.arange(Kp).view(1, -1)
    out = {}
    for t in range(terms):
        for p in range(parts):
            full = blocks[r // GR, k // 16, t, p, (r % GR) // 8, (k % 16) // 8, r % 8, k % 8]
            out[t, p] = full
    return out, rows, Rp, Kp


@pytest.mark.parametrize("tier", ["high", "default"])
@pytest.mark.parametrize("kind", range(len(KINDS)), ids=[k[0] for k in KINDS])
@pytest.mark.parametrize("n", [7, 13, 64, 128, 155, 240])
def test_packed_layout_is_the_split_matrices(n, kind, tier):
    _, body, mkind, inverse = KINDS[kind]
    mats = tdft.device_mats(mkind, n, inverse, CPU)
    n_in, n_out = mats[0].shape
    parts = 2 if tier == "high" else 1
    flat = tpdft.pack_mats(body, mats, tier)
    assert flat.dtype == torch.bfloat16 and flat.device == CPU
    got, rows, Rp, Kp = _unpack(flat, body, n_in, n_out, parts)
    if body == "r2c":
        terms = [torch.cat(mats, 1)]
    elif body == "c2r":  # re . cos + im . (-sin): the sign on the host
        terms = [mats[0], -mats[1]]
    else:
        terms = list(mats)
    for t, m in enumerate(terms):
        want = (m.to(torch.bfloat16),) if parts == 1 else tdft.split_bf16(m)
        for p in range(parts):
            full = torch.zeros((Rp, Kp), dtype=torch.bfloat16)
            full[:rows, :n_in] = want[p].T
            np.testing.assert_array_equal(_int_bits(got[t, p]), _int_bits(full))


def test_mat_layout_fits_the_path_widths():
    # r2c's [cos | sin] and c2r's n_out columns at the train (D = 64) and
    # bench (D = 155) widths
    assert tpdft.mat_layout("r2c", 33) == (1, 1, 66)
    assert tpdft.mat_layout("r2c", 78) == (1, 2, 156)
    assert tpdft.mat_layout("c2c", 240) == (3, 1, 240)
    assert tpdft.mat_layout("c2r", 64) == (2, 1, 64)
    assert tpdft.mat_layout("c2r", 155) == (2, 2, 155)
    with pytest.raises(ValueError, match="tensor-core"):
        tpdft.mat_layout("c2x", 33)


def test_split_is_shared_and_bit_equal_to_jax():
    assert tplane.split_bf16 is tdft.split_bf16
    x = np.array([0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45, 1.1754942e-38,
                  5e-39, -5e-39, 1.1754944e-38, 2.0 ** -126 + 2.0 ** -140,
                  # ties: 1 + 2^-8 and 1 + 3 * 2^-8 round to even
                  1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),
                  1.0 + 2.0 ** -8 + 2.0 ** -20, 1.0 + 2.0 ** -16, 1.0 + 2.0 ** -17,
                  1.5, 3e38, -3e38, 65504.0], np.float32)
    hi, lo = tdft.split_bf16(torch.from_numpy(x))
    jhi, jlo = _split_bf16(jnp.asarray(x))
    np.testing.assert_array_equal(
        _int_bits(hi), np.asarray(jax.lax.bitcast_convert_type(jhi, jnp.int16)))
    np.testing.assert_array_equal(
        _int_bits(lo), np.asarray(jax.lax.bitcast_convert_type(jlo, jnp.int16)))
    assert _int_bits(hi)[1] == np.int16(-32768)  # -0.0 keeps its sign in hi
    assert float(hi[11]) == 1.0 and float(hi[12]) == 1.0 + 2.0 ** -6  # to even


@pytest.mark.parametrize("bad", ["bf16", "HIGH", "float32", ""])
def test_unknown_tier_raises(bad):
    mats = tdft.device_mats("gauss", 8, False, CPU)
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="precision"):
        tpdft.check_tier(bad)
    with pytest.raises(ValueError, match="precision"):
        tpdft.lane_call("c2c", [x, x], mats, bad)
    with pytest.raises(ValueError, match="precision"):
        tpdft.plain("c2c", True, [x, x], mats, bad)
    with pytest.raises(ValueError, match="precision"):
        tpdft.pack_mats("c2c", mats, bad)
    with pytest.raises(ValueError, match="precision"):
        tpdft.rdft_nd_pair(torch.zeros(2, 4, 6), (1, 2), bad)


def test_routes():
    for body in ("r2c", "c2c", "c2r"):
        assert tpdft.route(body, "high") == tpdft.route(body, "default") == "wgmma"
        assert tpdft.route(body, "highest") == "simt"
    with pytest.raises(ValueError, match="float32"):
        tpdft.pack_mats("c2c", tdft.device_mats("gauss", 8, False, CPU), "highest")


def test_packed_matrices_are_cached_by_identity():
    mats = [m.clone() for m in tdft.device_mats("half", 12, False, CPU)]
    a = tpdft._packed("r2c", mats, "high")
    assert tpdft._packed("r2c", mats, "high") is a
    assert tpdft._packed("r2c", mats, "default") is not a
    mats[1].mul_(2.0)  # an in-place change bumps the version: packed anew
    b = tpdft._packed("r2c", mats, "high")
    assert b is not a and not torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_plain_high_is_the_bf16x3_sum():
    """hi.hi + (hi.lo + lo.hi): close to float32, not equal to it, and not
    the single bf16 pass."""
    rng = np.random.RandomState(9)
    mats = tdft.device_mats("gauss", 24, False, CPU)
    ins = [torch.from_numpy(rng.randn(30, 24).astype(np.float32)) for _ in range(2)]
    f32, high, one = (tpdft.plain("c2c", True, ins, mats, t)
                      for t in ("highest", "high", "default"))
    for a, b, c in zip(f32, high, one):
        scale = float(a.abs().max())
        assert 0 < float((b - a).abs().max()) / scale < 2e-5
        assert float((c - a).abs().max()) / scale > 1e-4
