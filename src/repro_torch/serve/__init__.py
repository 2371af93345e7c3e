"""Serving: the continuous-batching engine."""
