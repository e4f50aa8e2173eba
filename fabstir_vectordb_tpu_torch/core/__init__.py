"""Host-side types, metadata filters, columnar masks and schema: copies of
the JAX package's modules of the same names (none of them uses a device)."""
