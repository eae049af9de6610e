"""The port's chunked training (mvtb_tpu_torch/train/chunked.py) against the
JAX package's ``make_chunk_fn``: K = 3 steps over the same pool rows from
the same converted weights, with no stylization and with the test stack of
``test_torch_train_seg.py`` (JAX's draws replayed step by step from the key
chain the JAX chunk body builds: ``key, sub = split(key)``, then the step's
image key ``split(sub)[0]``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.models.unet3d import UNet as JUNet
from mvtb_tpu.ops import fused as jfused
from mvtb_tpu.train import chunked as jchunked
from mvtb_tpu.train import seg as jseg
from mvtb_tpu_torch.models import UNet, unet_params_from_flax
from mvtb_tpu_torch.ops import fused as tfused
from mvtb_tpu_torch.train import chunked as tchunked
from mvtb_tpu_torch.train import seg as tseg
from test_torch_fused_plane import jax_stage_draws
from test_torch_train_seg import STACK, _norm_fed_biases

CHANNELS, STRIDES, RES = (4, 8), (2,), 1
B, C, SPATIAL = 2, 4, (16, 16, 8)
K, POOL = 3, 6
LR = 1e-4


def _pool():
    rng = np.random.RandomState(21)
    images = rng.randn(POOL, C, *SPATIAL).astype(np.float32)
    labels = (rng.rand(POOL, 3, *SPATIAL) < 0.4).astype(np.float32)
    idxs = rng.randint(0, POOL, (K, B))
    return images, labels, idxs


def _jax_chunk(stack):
    jm = JUNet(out_channels=3, channels=CHANNELS, strides=STRIDES, num_res_units=RES)
    state = jseg.create_seg_state(jax.random.key(0), jm, (1,) + SPATIAL + (C,))
    p0 = jax.device_get(state.params)
    images, labels, idxs = _pool()
    cfg = None if stack is None else jfused.StylizeConfig(**stack, fft_backend="dft")
    key = jax.random.key(5)
    draws = None
    if cfg is not None:  # the draws of each step, from the chunk body's key chain
        draws, k = [], key
        for _ in range(K):
            k, sub = jax.random.split(k)
            draws.append(jax_stage_draws(jax.random.split(sub)[0], cfg, (B, C) + SPATIAL))
    state2, _, loss = jchunked.make_chunk_fn(cfg)(
        state, key, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(idxs))
    ams = state2.opt_state[1][0]
    moments = {n: unet_params_from_flax(jax.device_get(getattr(ams, n)))
               for n in ("mu", "nu", "nu_max")}
    return {"p0": p0, "params": unet_params_from_flax(jax.device_get(state2.params)),
            "loss": float(loss), "count": int(ams.count), "moments": moments,
            "draws": draws, "data": (images, labels, idxs)}


@pytest.fixture(scope="module", params=[None, STACK], ids=["no_stylize", "stack"])
def both(request):
    ref = _jax_chunk(request.param)
    model = UNet(C, 3, CHANNELS, STRIDES, RES, device="cpu")
    model.load_state_dict(unet_params_from_flax(ref["p0"]))
    state = tseg.create_seg_state(model, device="cpu")
    images, labels, idxs = ref["data"]
    cfg = None if request.param is None else tfused.StylizeConfig(**request.param,
                                                                  fft_backend="dft")
    gen = torch.Generator().manual_seed(0)
    state, gen_out, loss = tchunked.make_chunk_fn(cfg, device="cpu")(
        state, gen, torch.from_numpy(images), torch.from_numpy(labels),
        torch.from_numpy(idxs), draws=ref["draws"])
    assert gen_out is gen and state.step == K
    return ref, state, loss


def test_chunk_mean_loss_matches_jax(both):
    ref, _, loss = both
    assert loss.dtype == torch.float32 and loss.ndim == 0
    # measured 0.0 (no stylize) and 3.0e-8 (stack): float32 sums of the
    # same Dice terms in another order
    assert abs(float(loss) - ref["loss"]) < 1e-6


def test_chunk_parameters_and_moments_match_jax(both):
    ref, state, _ = both
    model, opt = state.model, state.optimizer
    zero = _norm_fed_biases(model)
    for name, p in model.named_parameters():
        st = opt.state[p]
        assert st["count"] == ref["count"] == K
        if name in zero:
            # exact gradient 0: both sides step on rounding noise, which
            # amsgrad normalises to up to lr a step (measured <= 7.5e-5)
            assert float((p.detach() - ref["params"][name]).abs().max()) <= K * LR * 1.01
            continue
        # measured <= 6.0e-8 (no stylize) and <= 4.0e-7 (stack): amsgrad's
        # step has size ~lr, so a gradient difference of ~1e-6 relative
        # moves a parameter by far less than lr
        assert float((p.detach() - ref["params"][name]).abs().max()) < 5e-6, name
        for m in ("mu", "nu_max"):
            r = ref["moments"][m][name]
            # measured <= 2.1e-5 of the moment's max (nu_max; mu <= 1.7e-6)
            assert float((st[m] - r).abs().max()) <= 1e-4 * float(r.abs().max()), (m, name)


def test_chunk_reads_pool_rows_by_index(monkeypatch):
    # each step's batch is pool rows idxs[i], in order, with its own draws
    seen = []

    def spy(state, image, label, cfg, draws=None, **kw):
        seen.append((image.clone(), label.clone(), draws))
        return torch.zeros(())

    images, labels, idxs = _pool()
    draws = [object() for _ in range(K)]
    monkeypatch.setattr(tchunked, "seg_train_step", spy)
    _, _, loss = tchunked.make_chunk_fn(None, device="cpu")(
        None, None, torch.from_numpy(images), torch.from_numpy(labels),
        torch.from_numpy(idxs), draws=draws)
    assert float(loss) == 0.0 and len(seen) == K
    for (img, lbl, d), row, want in zip(seen, idxs, draws):
        assert torch.equal(img, torch.from_numpy(images[row]))
        assert torch.equal(lbl, torch.from_numpy(labels[row]))
        assert d is want
    with pytest.raises(ValueError, match="draws"):
        tchunked.make_chunk_fn(None, device="cpu")(
            None, None, torch.from_numpy(images), torch.from_numpy(labels),
            torch.from_numpy(idxs), draws=draws[:1])


def test_train_chunked_reads_once_per_chunk():
    images, labels, _ = _pool()
    model = UNet(C, 3, CHANNELS, STRIDES, RES, device="cpu")
    state = tseg.create_seg_state(model, device="cpu")
    logged = []
    state, hist = tchunked.train_chunked(
        state, torch.from_numpy(images), torch.from_numpy(labels), steps=5,
        batch_size=B, chunk=2, log=logged.append, device="cpu")
    assert [h["step"] for h in hist] == [2, 4, 5] and state.step == 5
    assert all(np.isfinite(h["loss"]) for h in hist) and len(logged) == 3
