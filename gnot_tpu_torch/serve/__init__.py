"""Inference serving of the port: engine, batcher and server core."""
