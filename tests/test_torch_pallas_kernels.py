"""The port's pointwise kernels' plain versions (mvtb_tpu_torch/ops/
pallas_kernels.py) against the JAX package's, and the magnitude-edit tail.

The JAX Pallas kernels run as the JAX tests run them on the CPU, in
interpret mode. There the TPU PRNG gives zeros, so the salt & pepper kernel
turns every voxel into ``min/2``, even at p = 0: its stream cannot be
compared, and the port's Philox stream is held to the JAX op
``corruptions.salt_and_pepper`` given the port's field instead (bit-exact:
the same select on the same numbers), and to published Philox4x32-10
answers. The polar round trip is float32 ``sqrt``, ``log``, ``exp`` and
``/`` on both sides: elementwise within 1e-6 relative (a one-ulp
difference in ``log`` of a value near 1e-10 is 1.9e-6 of ``log``'s
magnitude but 6e-7 of ``exp``'s result).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.ops import corruptions as jcorr
from mvtb_tpu.ops.fourier import from_polar as jfrom_polar
from mvtb_tpu.ops.pallas_kernels import polar_roundtrip_pallas as jpolar
from mvtb_tpu.ops.pallas_kernels import salt_and_pepper_pallas as jsap
from mvtb_tpu_torch.ops import corruptions, pallas_kernels as pk
from mvtb_tpu_torch.utils import profiling

SHAPE = (2, 24, 20, 15)


def _x(seed=0, shape=SHAPE):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _words(*vals):
    return torch.tensor(vals, dtype=torch.int64)


@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, expected):
    assert pk.philox4x32(_words(*counter), key).tolist() == list(expected)
    batch = pk.philox4x32(torch.stack([_words(*counter)] * 3), key)
    assert batch.tolist() == [list(expected)] * 3


def test_sap_stream_depends_on_seed_and_index_only():
    u = pk.sap_uniform(1001, 5, "cpu")
    assert u.dtype == torch.float32 and tuple(u.shape) == (1001,)
    assert torch.equal(pk.sap_uniform(37, 5, "cpu"), u[:37])
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # 24-bit grid: every value times 2^24 is an integer
    assert torch.equal(u * 2 ** 24, torch.round(u * 2 ** 24))
    # word j of block t is element 4t + j, block t at counter (t, 0, 0, 0)
    block = pk.philox4x32(_words(10, 0, 0, 0), (5, 0))
    assert torch.equal(u[40:44], (block >> 8).to(torch.float32) * 2.0 ** -24)
    assert not torch.equal(pk.sap_uniform(64, 6, "cpu"), u[:64])
    # the seed's low 32 bits key the stream, as uint32(seed)
    assert torch.equal(pk.sap_uniform(64, -1, "cpu"), pk.sap_uniform(64, 0xFFFFFFFF, "cpu"))


@pytest.mark.parametrize("p", [0.0, 0.05, 0.4])
def test_plain_sap_matches_jax_op_on_the_port_field(p):
    x = _x()
    u = pk.sap_uniform(x.size, 11, "cpu").reshape(SHAPE)
    ref = np.asarray(jcorr.salt_and_pepper(jnp.asarray(x), p, u=jnp.asarray(u.numpy())))
    got = pk.salt_and_pepper_plain(torch.from_numpy(x), p, 11)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("p", [0.0, 0.4])
def test_select_on_zero_field_matches_interpreted_kernel(p):
    x = _x(1)
    ref = np.asarray(jsap(jnp.asarray(x), p, 7, interpret=True))
    t = torch.from_numpy(x)
    got = corruptions.sap_select(t, torch.zeros_like(t), torch.tensor(p),
                                 t.min() / 2, t.max() / 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.all(ref == x.min() / 2)  # the interpreter's PRNG gives zeros


def test_sap_shape_and_dtype_round_trip():
    x = torch.from_numpy(_x())
    out = pk.salt_and_pepper_pallas(x, 0.4, 7)
    ref = jsap(jnp.asarray(_x()), 0.4, 7, interpret=True)
    assert tuple(out.shape) == ref.shape == SHAPE
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert pk.salt_and_pepper_pallas(torch.zeros(0), 0.4, 7).shape == (0,)


def test_plain_sap_fraction_levels_and_seeds():
    x = torch.from_numpy(_x(2, (4, 40, 40, 31)))
    lo, hi = x.min() / 2, x.max() / 2
    out = pk.salt_and_pepper_plain(x, 0.4, 7)
    n = x.numel()
    pepper, salt = int((out == lo).sum()), int((out == hi).sum())
    changed = int((out != x).sum())
    sigma = (0.4 * 0.6 / n) ** 0.5
    assert abs(changed / n - 0.4) < 6 * sigma
    assert abs(pepper / n - 0.2) < 6 * (0.2 * 0.8 / n) ** 0.5
    assert abs(salt / n - 0.2) < 6 * (0.2 * 0.8 / n) ** 0.5
    assert pepper + salt == changed  # every changed voxel is a level
    keep = out == x
    assert torch.equal(out[keep], x[keep])
    assert torch.equal(out, pk.salt_and_pepper_plain(x, 0.4, 7))
    assert not torch.equal(out, pk.salt_and_pepper_plain(x, 0.4, 8))
    # p = 0 changes exactly the voxels whose u is 0
    u = pk.sap_uniform(n, 7, "cpu").reshape(x.shape)
    zero = pk.salt_and_pepper_plain(x, 0.0, 7)
    assert int((zero != x).sum()) == int((u == 0).sum())


def _kspace_with_zeros(seed=0):
    k = np.fft.fftn(_x(seed), axes=(-3, -2, -1)).astype(np.complex64)
    re, im = np.ascontiguousarray(k.real), np.ascontiguousarray(k.imag)
    re.flat[:8] = [0.0, -0.0, 1e-30, 0.0, 1e-40, -1e-30, -0.0, 3.0]
    im.flat[:8] = [0.0, 0.0, 0.0, -0.0, 1e-40, 1e-30, -2.0, -0.0]
    return re, im


def _elementwise_rel(got, ref):
    d = np.abs(got - ref)
    return float(np.max(np.where(d == 0, 0.0, d / np.maximum(np.abs(ref), 1e-38))))


def test_plain_polar_matches_interpreted_kernel():
    re, im = _kspace_with_zeros()
    ref = jpolar(jnp.asarray(re), jnp.asarray(im), interpret=True)
    got = pk.polar_roundtrip_plain(torch.from_numpy(re), torch.from_numpy(im))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        assert _elementwise_rel(g.numpy(), np.asarray(r)) <= 1e-6
    # |k| = 0 gives (mag, 0), mag = exp(log(1e-10))
    assert got[1][0, 0, 0, 0] == 0 and 0.9999e-10 < float(got[0][0, 0, 0, 0]) < 1.0001e-10
    wrapped = pk.polar_roundtrip_pallas(torch.from_numpy(re), torch.from_numpy(im))
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


def _config6_input():
    x = np.random.RandomState(0).randn(4, 24, 20, 15).astype(np.float32)
    return np.fft.fftn(x, axes=(-3, -2, -1)).astype(np.complex64)


def _config6_idx(C=4):
    return (torch.arange(C), torch.full((C,), 3), torch.full((C,), 5), torch.full((C,), 7))


def test_magnitude_edit_strategies_agree_with_jax_chain():
    k = _config6_input()
    idx = tuple(np.asarray(i) for i in _config6_idx())
    jk = jnp.asarray(k)
    log_abs = jnp.log(jnp.abs(jk) + 1e-10).at[idx].set(14.0)
    ref = np.asarray(jfrom_polar(jnp.exp(log_abs), jnp.angle(jk)))
    scale = float(np.abs(ref).max())
    outs = {s: pk.magnitude_edit(torch.from_numpy(k), _config6_idx(), 14.0, s).numpy()
            for s in pk.EDIT_STRATEGIES}
    for s, out in outs.items():
        assert out.dtype == np.complex64 and out.shape == k.shape
        assert float(np.abs(out - ref).max()) <= 1e-5 * scale, s
    assert np.allclose(np.abs(outs["scatter"][idx]), np.exp(np.float32(14.0)), rtol=1e-6)
    with pytest.raises(ValueError, match="strategy"):
        pk.magnitude_edit(torch.from_numpy(k), _config6_idx(), 14.0, "xla")


def test_wrappers_take_plain_only_for_cpu_tensors():
    x = torch.from_numpy(_x())
    before = profiling.counters.copy()
    assert torch.equal(pk.salt_and_pepper_pallas(x, 0.1, 3), pk.salt_and_pepper_plain(x, 0.1, 3))
    got = pk.polar_roundtrip_pallas(x, x.flip(0))
    assert all(torch.equal(a, b) for a, b in zip(got, pk.polar_roundtrip_plain(x, x.flip(0))))
    assert profiling.counters == before  # no kernel ran: no counter moved
    meta = x.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        pk.salt_and_pepper_pallas(meta, 0.1, 3)
    with pytest.raises(ValueError, match="no kernel"):
        pk.polar_roundtrip_pallas(meta, meta)
    with pytest.raises(NotImplementedError, match="sap"):
        pk.salt_and_pepper_pallas(x.double(), 0.1, 3)
    with pytest.raises(NotImplementedError, match="polar"):
        pk.polar_roundtrip_pallas(x.double(), x.double())
    with pytest.raises(ValueError, match="polar"):
        pk.polar_roundtrip_pallas(x, x[:1])
