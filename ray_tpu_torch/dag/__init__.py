"""The loop wire that moves KV pages and weights between engines."""
