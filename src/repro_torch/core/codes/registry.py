"""Code registry: build any code evaluated in the paper by family string.

`PAPER_CODES` is the full set of configurations appearing in §3.3 Fig. 3 and
§6 (Figs. 6–8): RS / MSR baselines and the five deployed DRC configs.
"""
from __future__ import annotations

from ..code_base import ErasureCode
from .drc_family1 import DRCFamily1
from .drc_family2 import DRCFamily2
from .msr_clay import MSRCode
from .rs_code import RSCode

_FAMILIES = {
    "RS": RSCode,
    "MSR": MSRCode,
}


def make_code(family: str, n: int, k: int, r: int | None = None) -> ErasureCode:
    family = family.upper()
    if family == "DRC":
        m = n - k
        if n % 3 == 0 and k == 2 * (n // 3) - 1 and (r in (None, 3)):
            return DRCFamily2(n, k, 3)
        if m >= 2 and n % m == 0 and (r in (None, n // m)):
            return DRCFamily1(n, k, r)
        raise ValueError(f"no DRC family matches ({n},{k},{r})")
    if family not in _FAMILIES:
        raise ValueError(f"unknown code family {family!r}")
    return _FAMILIES[family](n, k, r)


# Every configuration the paper evaluates (Fig. 3 groups by n-k; §6 testbed).
PAPER_CODES: list[tuple[str, int, int, int]] = [
    # --- n-k = 2 group (Fig. 3a) ---
    ("RS", 6, 4, 6),
    ("RS", 6, 4, 3),
    ("RS", 8, 6, 8),
    ("RS", 8, 6, 4),
    ("MSR", 6, 4, 6),
    ("MSR", 6, 4, 3),
    ("MSR", 8, 6, 8),
    ("MSR", 8, 6, 4),
    ("DRC", 6, 4, 3),
    ("DRC", 8, 6, 4),
    # --- n-k = 3 group (Fig. 3b) ---
    ("RS", 6, 3, 6),
    ("RS", 6, 3, 3),
    ("RS", 9, 6, 9),
    ("RS", 9, 6, 3),
    ("MSR", 6, 3, 6),
    ("MSR", 6, 3, 3),
    ("DRC", 6, 3, 3),
    ("DRC", 9, 6, 3),
    # --- n-k = 4 group (Fig. 3c) ---
    ("RS", 8, 4, 8),
    ("RS", 8, 4, 4),
    ("RS", 9, 5, 9),
    ("RS", 9, 5, 3),
    ("MSR", 8, 4, 8),
    ("MSR", 8, 4, 4),
    ("DRC", 8, 4, 2),
    ("DRC", 9, 5, 3),
]

# The five DRC configs implemented in the paper's DoubleR prototype (§4.1).
PROTOTYPE_DRC: list[tuple[int, int, int]] = [
    (6, 4, 3),  # Family 1
    (8, 6, 4),  # Family 1
    (9, 6, 3),  # Family 1
    (6, 3, 3),  # Family 2
    (9, 5, 3),  # Family 2
]
