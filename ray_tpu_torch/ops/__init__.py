"""Ops of the serving path: norms, RoPE and the paged decode kernel."""

from .norms import rms_norm
from .paged_attention import paged_decode_attention, stage_rows
from .rope import apply_rope, rope_frequencies

__all__ = ["apply_rope", "paged_decode_attention", "rms_norm",
           "rope_frequencies", "stage_rows"]
