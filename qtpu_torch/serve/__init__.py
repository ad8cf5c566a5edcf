"""Serving: flat int8 engines, dispatch policy and the batching runtime."""
