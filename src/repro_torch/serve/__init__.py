"""Serving stack of the port: the slot and paged engines, the block
allocator and the chunked-prefill scheduler."""
