"""The Mamba-2 (SSD) intra-chunk term: ``ops.intra_chunk`` (the wrapper)
and ``ref.ssd_intra_chunk_ref`` (its plain version)."""
