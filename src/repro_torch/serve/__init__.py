"""Serving stack of the port: the paged engine, its allocator and its
chunked-prefill scheduler."""
