from .serve_step import make_decode_step, make_prefill_step, sample_token
from .engine import ServeEngine

__all__ = ["make_decode_step", "make_prefill_step", "sample_token", "ServeEngine"]
