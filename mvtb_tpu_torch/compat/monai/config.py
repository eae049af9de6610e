"""``monai.config.print_config`` on the port."""

from __future__ import annotations


def print_config() -> None:
    import numpy as np
    import torch

    print("mvtb_tpu_torch monai compatibility shim")
    print(f"  backing framework: mvtb_tpu_torch (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, numpy {np.__version__})")
    names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    print(f"  CUDA devices: {names or 'none'}")
