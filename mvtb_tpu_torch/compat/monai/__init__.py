"""MONAI-name compatibility shim on the port (counterpart of
mvtb_tpu/compat/monai).

Reference experiment scripts import some 25 ``monai.*`` names beyond the
local ``source_code`` modules that ``mvtb_tpu_torch.compat.install()``
shims (``10_scripts/20_Gibbs_filters/baseline.py:8-30``,
``20_results/30_planes_waves/compare.py:7-31``). This package provides
them, backed by the port:

* ``monai.transforms``: :mod:`mvtb_tpu_torch.data.preprocess` and
  :mod:`mvtb_tpu_torch.transforms.base`, plus ``LoadImaged``,
  ``AddChanneld``, ``ToTensord``, ``Activations`` and ``AsDiscrete``;
* ``monai.apps.DecathlonDataset`` and ``monai.data``: manifest datasets
  with MONAI's split rule and deterministic-prefix caching;
* ``monai.networks.nets.UNet``: the port's UNet;
* ``monai.losses.DiceLoss`` and ``monai.metrics.DiceMetric``:
  :mod:`mvtb_tpu_torch.train.losses` and :mod:`mvtb_tpu_torch.eval.dice`.

Semantics the port keeps:

* ``networks.nets.UNet`` is the port's UNet, a real ``nn.Module`` in NCDHW
  on the device it is built on or moved to (``device=None``: the card). It
  takes both the ``dimensions=`` and the ``spatial_dims=`` spelling;
  ``dropout`` raises, as in the JAX shim.
* The reference's training loop runs with real autograd:
  ``DiceLoss(...)(model(x), y).backward()`` then ``Adam.step()`` trains the
  model. The JAX shim's gradient bridge has no counterpart and needs none.
  ``DiceLoss`` returns a torch scalar.
* Loaders yield CPU torch tensors, so ``.to(device)`` really moves them.
  The JAX shim's numpy ``ArrayTensor`` (``_tensor.py``), whose device
  methods do nothing, has no counterpart.
* ``state_dict`` uses the port UNet's own names. ``load_state_dict`` also
  takes the flax-keyed dict the JAX shim saves (``"ResidualUnit_0/
  ConvNormAct_0/Conv_0/kernel"``), converted by
  :mod:`mvtb_tpu_torch.models.convert`.

The package imports its parts relatively, so it works both as
``mvtb_tpu_torch.compat.monai`` and as a bare ``monai`` after
``install()``.
"""

from . import (  # noqa: F401
    apps,
    config,
    data,
    losses,
    metrics,
    networks,
    transforms,
    utils,
)

__version__ = "0.5.0+mvtb_tpu_torch"
