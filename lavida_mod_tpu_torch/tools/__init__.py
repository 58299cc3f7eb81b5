"""Checkpoint file tools: the safetensors format and weight deltas."""
