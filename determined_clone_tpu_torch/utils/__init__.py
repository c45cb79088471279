"""Utilities: batch iterators, device feeders, retries."""
