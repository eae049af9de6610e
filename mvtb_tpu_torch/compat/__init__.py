"""Reference import-path shims (counterpart of mvtb_tpu/compat).

Add this directory to ``sys.path`` (or call :func:`install`) and the
reference experiment scripts' local imports (``filters_and_operators``,
``stylization_layers``, ``utils``) and their ``monai.*`` imports resolve
against the port. Import them by package path
(``mvtb_tpu_torch.compat.filters_and_operators``,
``mvtb_tpu_torch.compat.monai``) where another ``monai`` may already be on
the path.
"""

import os
import sys


def install() -> None:
    """Make the reference's bare module names importable."""
    here = os.path.dirname(__file__)
    if here not in sys.path:
        sys.path.insert(0, here)
