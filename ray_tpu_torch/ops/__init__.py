"""Ops of the model paths: norms, RoPE, flash attention (training), ring
and Ulysses attention over a sequence-parallel axis, and the paged decode
kernel (serving)."""

from .attention import flash_attention, mha_reference
from .norms import rms_norm
from .paged_attention import paged_decode_attention, stage_rows
from .ring_attention import ring_attention
from .rope import apply_rope, rope_frequencies
from .ulysses import ulysses_attention

__all__ = ["apply_rope", "flash_attention", "mha_reference",
           "paged_decode_attention", "ring_attention", "rms_norm",
           "rope_frequencies", "stage_rows", "ulysses_attention"]
