"""Serving: the batched voice pool and the control wire protocol."""
