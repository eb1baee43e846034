"""Model configuration, topology, parameters, blocks and serving."""
