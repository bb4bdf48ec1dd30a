"""Device resolution for the port (single card in this slice)."""
