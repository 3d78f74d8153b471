"""Serving path of the port: block allocator, engine and HTTP surface."""
