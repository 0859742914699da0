"""Plain torch oracle for the GF(2^8) product kernel (mul-table path)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gf_torch import gf_matmul_table


def gf_matmul_ref(m: torch.Tensor | np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Reference GF(256) product: (R, K) x (K, B) -> (R, B), all uint8."""
    return gf_matmul_table(m, x)
