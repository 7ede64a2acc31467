"""Ops of the model paths: norms, RoPE, flash attention (training) and
the paged decode kernel (serving)."""

from .attention import flash_attention, mha_reference
from .norms import rms_norm
from .paged_attention import paged_decode_attention, stage_rows
from .rope import apply_rope, rope_frequencies

__all__ = ["apply_rope", "flash_attention", "mha_reference",
           "paged_decode_attention", "rms_norm", "rope_frequencies",
           "stage_rows"]
