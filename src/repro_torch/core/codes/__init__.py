from .rs_code import RSCode
from .msr_clay import MSRCode
from .drc_family1 import DRCFamily1
from .drc_family2 import DRCFamily2
from .registry import make_code, PAPER_CODES

__all__ = [
    "RSCode",
    "MSRCode",
    "DRCFamily1",
    "DRCFamily2",
    "make_code",
    "PAPER_CODES",
]
