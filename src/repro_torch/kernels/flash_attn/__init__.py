"""Causal flash attention: ``ops.causal_attention`` (the wrapper) and
``ref.flash_attention_ref`` (its plain version)."""
