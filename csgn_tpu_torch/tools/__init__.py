"""Tools of the port: `enc_stats`, the Philox engine's statistics."""
