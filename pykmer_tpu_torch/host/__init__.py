"""Host-side (numpy) stages of the index path: FASTA decode, record-aligned
segments and the streaming reader, the pipelined chunk producer, chunk
framing."""
