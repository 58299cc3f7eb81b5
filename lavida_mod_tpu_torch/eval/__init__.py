"""The batched evaluation / serving adapter of the port."""
