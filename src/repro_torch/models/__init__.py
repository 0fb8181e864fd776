"""Model zoo of the PyTorch port: the dense, MoE, RG-LRU hybrid and SSD
decoder families, their sequence path and their decode path."""
