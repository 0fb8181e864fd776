"""Environment-knob registry of the PyTorch port (see ``env``)."""
