"""Data loading and batching of the port (numpy on the host, tensors out)."""
