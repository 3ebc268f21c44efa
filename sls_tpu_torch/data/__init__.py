"""Host-side data: fixed-length crops, wire formats, in-memory batches."""
