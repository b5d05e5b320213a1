"""Serving stack of the port: scheduler and page pool (copies of the
reference's numpy-only modules), executor, engine and CLI."""
