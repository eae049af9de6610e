"""``monai.losses.DiceLoss`` over :func:`mvtb_tpu_torch.train.losses.dice_loss`.

The same formula in the configuration the reference uses
(``baseline.py:207``: sigmoid, squared_pred, include_background, mean
reduction). The loss is a torch scalar on the prediction's device, so
``loss.backward()`` trains the model by autograd."""

from __future__ import annotations

import torch

from mvtb_tpu_torch.train.losses import dice_loss


class DiceLoss(torch.nn.Module):
    def __init__(self, include_background: bool = True,
                 to_onehot_y: bool = False, sigmoid: bool = False,
                 softmax: bool = False, squared_pred: bool = False,
                 jaccard: bool = False, reduction: str = "mean",
                 smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
                 batch: bool = False):
        super().__init__()
        if to_onehot_y or softmax or jaccard or batch or reduction != "mean":
            raise NotImplementedError(
                "the DiceLoss shim covers the reference's configuration "
                "(sigmoid/squared_pred/include_background, mean reduction)")
        self.include_background = include_background
        self.sigmoid = sigmoid
        self.squared_pred = squared_pred
        self.smooth_nr = smooth_nr
        self.smooth_dr = smooth_dr

    def forward(self, input, target) -> torch.Tensor:
        pred = torch.as_tensor(input)
        tgt = torch.as_tensor(target).to(device=pred.device, dtype=pred.dtype)
        return dice_loss(pred, tgt, sigmoid=self.sigmoid,
                         squared_pred=self.squared_pred, smooth_nr=self.smooth_nr,
                         smooth_dr=self.smooth_dr,
                         include_background=self.include_background)
