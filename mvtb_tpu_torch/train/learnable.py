"""Learnable-stylization training: joint gradients or the reference's finite
differences (counterpart of mvtb_tpu/train/learnable.py).

The reference trains ``Gibbs_UNet`` with Adam on the UNet and moves the
Gibbs alpha by finite differences (``gibbs0p7_layer_domain_GD.py:252-298``:
``delta = (loss(a + h) - loss(a)) / h; a -= lr * delta``, h = 0.01,
lr = 0.02), because its hard mask has no gradient in alpha. Here:

* :func:`learnable_train_step`: one backward over every parameter, alpha
  (or the spike intensity) included, and one optimizer step;
* :func:`fd_train_step`: the backward updates the network while the
  stylization parameter's gradient is zero; then the parameter moves by the
  two-extra-forward finite difference (with ``hard=True`` masks too).

Both follow the JAX steps, the places where they differ from the reference
included: the stylization parameter always reaches the optimizer, with a
zero gradient where it does not train, so under the reference optimizer
its coupled L2 decay still moves it by about ``lr`` a step (ROADMAP.md
section 3). The steps take the model's ``locs`` (the spike layer's draws)
or draw them once from ``generator``; every forward of a step sees the same
draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.parallel import dp
from mvtb_tpu_torch.train.losses import dice_loss
from mvtb_tpu_torch.train.seg import SegState, reference_optimizer


def _styl_path(model: torch.nn.Module) -> Tuple[str, str]:
    """Where the stylization parameter lives: ``gibbs.alpha`` in a
    ``GibbsUNet``, ``spike.intensity`` in a ``SpikesUNet``."""
    if hasattr(model, "gibbs"):
        return ("gibbs", "alpha")
    if hasattr(model, "spike"):
        return ("spike", "intensity")
    raise KeyError("no stylization layer (gibbs/spike) in the model")


def styl_param(model: torch.nn.Module) -> torch.nn.Parameter:
    """The model's stylization parameter, shape (1,)."""
    layer, name = _styl_path(model)
    return getattr(getattr(model, layer), name)


def _draws(model: torch.nn.Module, image: torch.Tensor, locs, generator, mesh=None):
    """The step's spike locations: given, drawn once from ``generator``
    (``SpikesUNet``), or None (``GibbsUNet`` draws nothing). Under a mesh
    they are the global batch's, cut to this rank's rows."""
    if locs is None and hasattr(model, "spike"):
        B = image.shape[0]
        like = image if mesh is None else image[:1].expand(
            dp.global_batch_size(mesh, B), *image.shape[1:])
        locs = model.spike.sample_locations(like, generator)
    if locs is not None and mesh is not None:
        locs = locs[dp.data_rows(mesh, image.shape[0])]
    return locs


def _backward_and_step(state: SegState, loss: torch.Tensor, styl: torch.Tensor,
                       train_styl: bool, mesh=None) -> None:
    """Backward, then the optimizer step with the stylization parameter's
    gradient zeroed unless ``train_styl``. A zero tensor, not None: JAX's
    optimizer sees a zero gradient and still decays the parameter. The hard
    mask's output does not depend on alpha at all, so alpha then has no
    gradient of its own, and a frozen UNet behind it leaves none to take."""
    if loss.requires_grad:
        loss.backward()
    if not train_styl or styl.grad is None:
        styl.grad = torch.zeros_like(styl)
    if mesh is not None:
        dp.mean_gradients(state.model.parameters(), mesh)
    state.optimizer.step()
    state.step += 1


def learnable_train_step(state: SegState, image: torch.Tensor, label: torch.Tensor,
                         locs: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         train_alpha: bool = True, device: DeviceLike = None,
                         mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One joint step over every parameter (``image`` and ``label``
    channel-first); returns the detached ``(loss, alpha)``, alpha being the
    stylization parameter after the step (the reference logs its trajectory,
    ``gibbs_trajectory_*.txt``). ``train_alpha=False`` zeroes its gradient
    (the reference's no-GD scripts). ``device=None`` means ``"cuda"``; the
    state must already live there.

    ``mesh`` makes the step data-parallel (``image``, ``label`` this rank's
    rows; ``locs`` the global batch's; the gradients, alpha's too, averaged
    over ``data``; the loss the global mean), as ``seg_train_step``'s."""
    dev = resolve_device(device)
    image, label = image.to(dev), label.to(dev)
    model, styl = state.model, styl_param(state.model)
    locs = _draws(model, image, locs, generator, mesh)
    state.optimizer.zero_grad(set_to_none=True)
    loss = dice_loss(model(image, locs), label)
    _backward_and_step(state, loss, styl, train_alpha, mesh)
    loss = loss.detach() if mesh is None else dp.global_mean(loss, mesh)
    return loss, styl.detach()[0].clone()


def fd_train_step(state: SegState, image: torch.Tensor, label: torch.Tensor,
                  locs: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  h: float = 0.01, lr: float = 0.02, device: DeviceLike = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference-faithful step (``Gibbs_GD``,
    ``gibbs0p7_layer_domain_GD.py:252-269``): backprop updates the network
    (the stylization parameter's gradient zeroed), then two no-grad
    forwards of the same batch and draws on the updated parameters give
    ``loss(a)`` and ``loss(a + h)``, and ``a - lr * (loss(a + h) - loss(a))
    / h`` is stored unclipped (the forward clips). Returns the detached
    ``(loss, alpha)``: the loss before the update, alpha after it."""
    dev = resolve_device(device)
    image, label = image.to(dev), label.to(dev)
    model, styl = state.model, styl_param(state.model)
    locs = _draws(model, image, locs, generator)
    state.optimizer.zero_grad(set_to_none=True)
    loss = dice_loss(model(image, locs), label)
    _backward_and_step(state, loss, styl, False)
    with torch.no_grad():
        alpha = styl.clone()
        l0 = dice_loss(model(image, locs), label)
        styl.copy_(alpha + h)
        lh = dice_loss(model(image, locs), label)
        new_alpha = alpha - lr * ((lh - l0) / h)
        styl.copy_(new_alpha)
    return loss.detach(), new_alpha[0]


def create_learnable_state(model: torch.nn.Module, freeze_unet: bool = False,
                           unet_optimizer: str = "adam", transfer_params=None,
                           lr: float = 1e-4, weight_decay: float = 1e-5,
                           device: DeviceLike = None) -> SegState:
    """Move a ``GibbsUNet`` / ``SpikesUNet`` to ``device`` (None means
    ``"cuda"``) and pair it with its optimizer: :func:`~mvtb_tpu_torch.
    train.seg.reference_optimizer` (``lr``, ``weight_decay``), or plain SGD
    at ``lr`` for ``unet_optimizer="sgd"`` (the reference's GD variants).

    ``freeze_unet`` trains only the stylization parameter: the UNet's
    parameters stop requiring gradients and stay out of the optimizer, so
    they never move (JAX's ``set_to_zero``). ``transfer_params``, a UNet
    state_dict (or one whose UNet keys start with ``unet.``), warm-starts
    the UNet (``gibbs0p7_layer_domain_GD.py:218-233``).
    """
    dev = resolve_device(device)
    model = model.to(dev)
    if transfer_params is not None:
        unet = {k[len("unet."):]: v for k, v in transfer_params.items()
                if k.startswith("unet.")}
        model.unet.load_state_dict(unet or transfer_params)
    if freeze_unet:
        model.unet.requires_grad_(False)
        params = [styl_param(model)]
    else:
        params = list(model.parameters())
    if unet_optimizer == "sgd":
        optimizer = torch.optim.SGD(params, lr=lr)
    else:
        optimizer = reference_optimizer(params, lr, weight_decay)
    return SegState(model=model, optimizer=optimizer)
