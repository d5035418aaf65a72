"""Host-side (numpy) stages of the index path: FASTA decode and chunk framing."""
