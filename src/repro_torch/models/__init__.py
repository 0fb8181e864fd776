"""Model zoo of the PyTorch port: the dense decoder family (sequence path)."""
